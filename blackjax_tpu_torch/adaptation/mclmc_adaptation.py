"""MCLMC tuning: the decoherence length L, the step size and the diagonal
preconditioner of the unadjusted microcanonical sampler (reference
``blackjax_tpu/adaptation/mclmc_adaptation.py``).

Three phases on one chain: step-size control toward an energy-variance
target, then the same with the position's variances streamed (for L and the
preconditioner, with a re-equilibration after the preconditioner is swapped
in), then L from the effective sample size of a pilot run. Each of the
reference's ``lax.scan``s is a Python loop here. The step-size controller
and the variance stream are 0-d and ``(d,)`` tensors on the position's
device, and their guards are ``torch.where``s, as the reference's are
``jnp.where``s: a tuning step reads nothing back to the host.
"""
import math
from typing import NamedTuple

import torch

from blackjax_tpu_torch.diagnostics import effective_sample_size
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.types import Array
from blackjax_tpu_torch.util import generate_unit_vector, tree_map

__all__ = [
    "MCLMCAdaptationState",
    "mclmc_find_L_and_step_size",
    "make_L_step_size_adaptation",
    "make_adaptation_L",
]


class MCLMCAdaptationState(NamedTuple):
    L: Array
    step_size: Array
    inverse_mass_matrix: Array


class _EpsController(NamedTuple):
    """Decayed confidence-weighted estimate of the optimal step size:
    ``inv6_sum / conf_sum`` is the running mean of ``eps_opt**-6``, the
    proposal its ``-1/6`` power, capped at ``ceiling``, which a divergent
    transition lowers."""

    conf_sum: Array
    inv6_sum: Array
    ceiling: Array


def _controller_propose(ctrl, eps, sq_energy_change, dim, target_var, trust, decay):
    ratio = sq_energy_change / (dim * target_var) + 1e-8
    # confidence decays as a log-normal in the measured ratio (6 is the
    # exponent of the leapfrog error law, `trust` widens the band)
    confidence = torch.exp(-0.5 * torch.square(torch.log(ratio) / (6.0 * trust)))
    conf_sum = decay * ctrl.conf_sum + confidence
    inv6_sum = decay * ctrl.inv6_sum + confidence * ratio / eps**6.0
    proposal = torch.pow(inv6_sum / conf_sum, -1.0 / 6.0)
    proposal = torch.minimum(proposal, ctrl.ceiling)
    return _EpsController(conf_sum, inv6_sum, ctrl.ceiling), proposal


class _VarStream(NamedTuple):
    """Weighted online first and raw second moments of the position."""

    wsum: Array
    mean: Array
    mean_sq: Array


def _var_stream_init(dim, *, dtype=None, device=None):
    zeros = torch.zeros(dim, dtype=dtype, device=device)
    return _VarStream(torch.zeros((), dtype=dtype, device=device), zeros, zeros.clone())


def _var_stream_push(stream, x, weight):
    wsum = stream.wsum + weight
    gain = torch.where(wsum > 0.0, weight / torch.where(wsum > 0.0, wsum, 1.0), 0.0)
    return _VarStream(
        wsum,
        stream.mean + gain * (x - stream.mean),
        stream.mean_sq + gain * (torch.square(x) - stream.mean_sq),
    )


def _var_stream_read(stream):
    return stream.mean_sq - torch.square(stream.mean)


def _guarded_transition(kernel, logdensity_fn):
    """One kernel call with divergence recovery.

    A transition is clean when the kernel reports no NaNs and the energy
    change is finite. A dirty one keeps the pre-step state, lowers the
    controller's ceiling to ``0.8 * eps`` and reports zero energy change;
    if the log density itself went NaN, the momentum direction is redrawn.
    After the kernel's draws, the transition draws that fresh direction
    from the same generator every time.
    """

    def transition(rng_key, state, params, ceiling):
        proposed, info = kernel(
            rng_key=rng_key,
            state=state,
            logdensity_fn=logdensity_fn,
            inverse_mass_matrix=params.inverse_mass_matrix,
            L=params.L,
            step_size=params.step_size,
        )
        clean = info.nonans & torch.isfinite(info.energy_change)
        kept = tree_select(clean, tree_map(torch.nan_to_num, proposed), state)
        fresh = generate_unit_vector(rng_key, state.position)
        momentum = tree_select(torch.isnan(proposed.logdensity), fresh, kept.momentum)
        kept = kept._replace(momentum=momentum)
        ceiling = torch.where(clean, ceiling, 0.8 * params.step_size)
        delta_e = torch.where(clean, info.energy_change, 0.0)
        return kept, clean, delta_e, ceiling

    return transition


def make_L_step_size_adaptation(
    kernel,
    logdensity_fn,
    dim,
    frac_tune1,
    frac_tune2,
    diagonal_preconditioning,
    desired_energy_var=1e-3,
    trust_in_estimate=1.5,
    num_effective_samples=150,
):
    """Phases 1 and 2 of the MCLMC warmup: step-size control plus streamed
    position variances (for ``L`` and the diagonal preconditioner)."""
    decay = (num_effective_samples - 1.0) / (num_effective_samples + 1.0)
    transition = _guarded_transition(kernel, logdensity_fn)

    def run_phase(state, params, ctrl, stream, rng_key, num_steps, stream_gate):
        for _ in range(num_steps):
            state, clean, delta_e, ceiling = transition(rng_key, state, params, ctrl.ceiling)
            ctrl, eps = _controller_propose(
                ctrl._replace(ceiling=ceiling),
                params.step_size,
                torch.square(delta_e),
                dim,
                desired_energy_var,
                trust_in_estimate,
                decay=decay,
            )
            params = params._replace(step_size=eps)
            # clean transitions feed the variance stream, weighted by the
            # step size actually travelled
            stream = _var_stream_push(stream, state.position, clean * eps * stream_gate)
        return state, params, ctrl, stream

    def adapt(state, params, num_steps, rng_key):
        n1 = round(num_steps * frac_tune1)
        n2 = round(num_steps * frac_tune2)
        like = dict(dtype=state.position.dtype, device=state.position.device)
        zero = torch.zeros((), **like)
        ctrl = _EpsController(zero, zero, torch.full((), math.inf, **like))
        stream = _var_stream_init(dim, **like)

        # phase 1: pure step-size burn-in
        state, params, ctrl, stream = run_phase(state, params, ctrl, stream, rng_key, n1, 0.0)
        # phase 2: keep controlling eps, stream position variances
        state, params, ctrl, stream = run_phase(state, params, ctrl, stream, rng_key, n2, 1.0)

        L = params.L
        imm = params.inverse_mass_matrix
        if n2 > 1:
            variances = _var_stream_read(stream)
            L = torch.sqrt(torch.sum(variances))
            if diagonal_preconditioning:
                # swap the metric in and let the controller re-equilibrate eps
                imm = variances
                params = params._replace(inverse_mass_matrix=imm)
                L = torch.sqrt(torch.tensor(float(dim), **like))
                state, params, ctrl, stream = run_phase(
                    state, params, ctrl, stream, rng_key, round(n2 / 3), 1.0
                )
        return state, MCLMCAdaptationState(L, params.step_size, imm)

    return adapt


def make_adaptation_L(kernel, logdensity_fn, frac, l_factor):
    """Phase 3: ``L`` from the integrated autocorrelation time of a pilot
    run, ``L = l_factor * eps * mean_d(tau_d)`` with ``tau_d = n / ESS_d``."""

    def adapt(state, params, num_steps, rng_key):
        n = round(num_steps * frac)
        draws = []
        for _ in range(n):
            state, _ = kernel(
                rng_key=rng_key,
                state=state,
                logdensity_fn=logdensity_fn,
                inverse_mass_matrix=params.inverse_mass_matrix,
                L=params.L,
                step_size=params.step_size,
            )
            draws.append(state.position)
        tau = n / effective_sample_size(torch.stack(draws)[None, ...])
        return state, params._replace(L=l_factor * params.step_size * torch.mean(tau))

    return adapt


def mclmc_find_L_and_step_size(
    mclmc_kernel,
    num_steps,
    state,
    rng_key,
    logdensity_fn=None,
    frac_tune1=0.1,
    frac_tune2=0.1,
    frac_tune3=0.1,
    desired_energy_var=5e-4,
    trust_in_estimate=1.5,
    num_effective_samples=150,
    diagonal_preconditioning=True,
    params=None,
    l_factor=0.4,
):
    """Three-phase MCLMC warmup of one chain (a ``(d,)`` position). Returns
    ``(state, MCLMCAdaptationState, total_tuning_steps)``; ``L`` and the
    step size are 0-d tensors and the inverse mass matrix a ``(d,)`` tensor,
    on the position's device.

    Phases 1 and 2 control the step size toward the per-dimension
    energy-variance target and stream the position's variances for ``L``
    and the preconditioner (:func:`make_L_step_size_adaptation`); phase 3
    refines ``L`` from the effective sample size of a pilot run
    (:func:`make_adaptation_L`). Every draw comes from ``rng_key``, a
    ``torch.Generator``.
    """
    if logdensity_fn is None:
        raise ValueError("logdensity_fn is required.")
    position = state.position
    if position.dim() != 1:
        raise ValueError(
            f"the MCLMC tuner runs one chain: a (d,) position, got {tuple(position.shape)}"
        )
    dim = position.shape[-1]
    like = dict(dtype=position.dtype, device=position.device)
    if params is None:
        params = MCLMCAdaptationState(
            math.sqrt(dim), 0.25 * math.sqrt(dim), torch.ones(dim, **like)
        )
    params = MCLMCAdaptationState(
        *(torch.as_tensor(v, **like) for v in params)
    )

    n1 = round(num_steps * frac_tune1)
    n2 = round(num_steps * frac_tune2)
    n2 += diagonal_preconditioning * (n2 // 3)
    n3 = round(num_steps * frac_tune3)

    state, params = make_L_step_size_adaptation(
        kernel=mclmc_kernel,
        logdensity_fn=logdensity_fn,
        dim=dim,
        frac_tune1=frac_tune1,
        frac_tune2=frac_tune2,
        desired_energy_var=desired_energy_var,
        trust_in_estimate=trust_in_estimate,
        num_effective_samples=num_effective_samples,
        diagonal_preconditioning=diagonal_preconditioning,
    )(state, params, num_steps, rng_key)
    total = n1 + n2

    if n3 >= 2:
        state, params = make_adaptation_L(
            mclmc_kernel, logdensity_fn, frac=frac_tune3, l_factor=l_factor
        )(state, params, num_steps, rng_key)
        total += n3

    return state, params, total
