"""The staged warmup engine: Stan's three-phase schedule (reference
``blackjax_tpu/adaptation/staged_adaptation.py``).

The reference runs the whole warmup as one ``lax.scan`` with branch-free
window dispatch. Here it is a Python loop over the schedule, and the window
dispatch is an ``if``. A run is single-chain (a ``(1, d)`` block) or a
block of ``n_chains`` chains stepped together by the kernel, which the
reference vmaps; the block shares one step size, makes one dual-averaging
update per step on the mean acceptance rate (``n_chains`` probes of the
same step size are one observation), and feeds its ``(n_chains, d)``
positions to the metric core in one batched call.

Ported: the Welford and low-rank cores of ``metric_recipes`` (and any
``MetricCore``); a core's state may hold ``None`` where an
``adaptation_info_fn`` dropped a field, and the stacked info keeps it. ``metric="auto"`` (the meta-adaptation controller, ROADMAP
queue 1, item 6) and ``axis_name`` (a warmup sharded over devices, queue 1,
item 12) raise ``NotImplementedError``.
"""
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from blackjax_tpu_torch.adaptation.base import AdaptationResults, return_all_adapt_info
from blackjax_tpu_torch.adaptation.metric_recipes import MetricCore, MetricRecipe, lookup_recipe
from blackjax_tpu_torch.adaptation.step_size import (
    DualAveragingAdaptationState,
    dual_averaging_adaptation,
)
from blackjax_tpu_torch.base import AdaptationAlgorithm
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = ["StagedAdaptationState", "build_schedule", "staged_adaptation"]


class StagedAdaptationState(NamedTuple):
    ss_state: DualAveragingAdaptationState
    imm_state: Any
    step_size: float
    inverse_mass_matrix: Array


def _refuse_axis_name(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name (a warmup sharded over devices) is not ported yet: "
            "ROADMAP queue 1, item 12"
        )


def _make_engine(
    metric_core: MetricCore,
    *,
    target_acceptance_rate: float,
    pool_acceptance: bool = False,
    axis_name: Optional[str] = None,
) -> tuple[Callable, Callable, Callable]:
    """Build ``(init, update, final)`` for the warmup state. Dual averaging
    of the step size lives here; the mass matrix is the ``metric_core``'s.

    ``update(state, (stage, is_middle_window_end), position, grad,
    acceptance_rate)``: stage 0 is a fast step (step size only), stage 1 a
    slow one (step size and metric); a middle window's end folds the window
    into a new inverse mass matrix and restarts dual averaging from the
    current averaged step size. ``position`` and ``grad`` are ``(M, d)``
    blocks; with ``pool_acceptance`` the mean of the ``(M,)`` acceptance
    rates is one observation, without it the block is one chain."""
    _refuse_axis_name(axis_name)
    da_init, da_update, da_final = dual_averaging_adaptation(target_acceptance_rate)

    def _da_step(ss_state, acceptance_rate):
        rate = torch.as_tensor(acceptance_rate)
        if pool_acceptance:
            rate = rate.mean()
        return da_update(ss_state, float(rate))

    def init(position, initial_step_size: float) -> StagedAdaptationState:
        position = torch.as_tensor(position)
        imm_state = metric_core.init(
            position.shape[-1], dtype=position.dtype, device=position.device
        )
        return StagedAdaptationState(
            da_init(initial_step_size),
            imm_state,
            float(initial_step_size),
            imm_state.inverse_mass_matrix,
        )

    def _flatten(tree):
        return None if tree is None else tree.reshape(-1, tree.shape[-1])

    def update(
        adaptation_state: StagedAdaptationState,
        adaptation_stage,
        position,
        grad,
        acceptance_rate,
    ) -> StagedAdaptationState:
        stage, is_middle_window_end = (int(v) for v in adaptation_stage)
        ws = adaptation_state
        imm_state = ws.imm_state
        if stage == 1:
            imm_state = metric_core.update(imm_state, _flatten(position), _flatten(grad))
        ss_state = _da_step(ws.ss_state, acceptance_rate)
        if is_middle_window_end:
            # fold the window into a new metric, restart dual averaging from
            # the current averaged step size
            imm_state = metric_core.final(imm_state)
            ss_state = da_init(da_final(ss_state))
        return StagedAdaptationState(
            ss_state,
            imm_state,
            math.exp(ss_state.log_step_size),
            imm_state.inverse_mass_matrix,
        )

    def final(ws: StagedAdaptationState):
        return math.exp(ws.ss_state.log_step_size_avg), ws.imm_state.inverse_mass_matrix

    return init, update, final


def build_schedule(
    num_steps: int,
    initial_buffer_size: int = 75,
    final_buffer_size: int = 50,
    first_window_size: int = 25,
) -> Array:
    """Stan's warmup schedule as a ``(num_steps, 2)`` int64 tensor of
    ``(stage, is_middle_window_end)``: a fast step-size buffer, then doubling
    slow (covariance) windows, then a final fast buffer. Window sizes shrink
    in proportion when ``num_steps`` is small; below 20 steps everything is
    fast (no mass-matrix adaptation)."""
    schedule = []
    if num_steps < 20:
        schedule = [(0, False)] * num_steps
    else:
        if initial_buffer_size + first_window_size + final_buffer_size > num_steps:
            initial_buffer_size = int(0.15 * num_steps)
            final_buffer_size = int(0.1 * num_steps)
            first_window_size = num_steps - initial_buffer_size - final_buffer_size

        schedule += [(0, False)] * initial_buffer_size

        final_buffer_start = num_steps - final_buffer_size
        window_start, window_size = initial_buffer_size, first_window_size
        while window_start < final_buffer_start:
            size = window_size
            # the last window absorbs the remainder rather than leave a stub
            if 3 * size > final_buffer_start - window_start:
                size = final_buffer_start - window_start
            else:
                window_size = 2 * size
            schedule += [(1, False)] * (size - 1) + [(1, True)]
            window_start += size

        schedule += [(0, False)] * final_buffer_size

    return torch.tensor(schedule, dtype=torch.int64).reshape(-1, 2)


def _resolve_metric(metric, metric_options, *, schedule_fn=None) -> tuple[MetricCore, Callable]:
    if metric == "auto":
        raise NotImplementedError(
            "metric='auto' (the meta-adaptation controller) is not ported yet: "
            "ROADMAP queue 1, item 6"
        )
    resolved_schedule = build_schedule if schedule_fn is None else schedule_fn
    if isinstance(metric, MetricCore):
        return metric, resolved_schedule
    if isinstance(metric, MetricRecipe):
        return metric.build_core(**metric_options), resolved_schedule
    if isinstance(metric, str):
        return lookup_recipe(metric).build_core(**metric_options), resolved_schedule
    raise ValueError(
        f"metric must be a recipe name, MetricRecipe or MetricCore; got {metric!r}"
    )


def staged_adaptation(
    algorithm,
    logdensity_fn: Callable,
    *,
    metric: Union[str, MetricRecipe, MetricCore] = "welford_diag",
    metric_options: Optional[dict] = None,
    schedule_fn: Optional[Callable] = None,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.80,
    initial_metric_state=None,
    adaptation_info_fn: Callable = return_all_adapt_info,
    n_chains: int = 1,
    max_grad_budget: Optional[int] = None,
    axis_name: Optional[str] = None,
    **extra_parameters,
) -> AdaptationAlgorithm:
    """Run the staged warmup for an HMC-family ``algorithm`` (a module-like
    object with ``init`` and ``build_kernel``).

    ``run(generator, position, num_steps)`` takes a ``(d,)`` position or a
    ``(1, d)`` block when ``n_chains == 1``, an ``(n_chains, d)`` block
    otherwise, and returns ``(AdaptationResults(state, parameters), info)``:
    the last state (a block, with its chain axis), ``parameters`` with the
    adapted ``step_size`` (a number) and ``inverse_mass_matrix`` plus
    ``extra_parameters``, and ``adaptation_info_fn(state, info,
    adaptation_state)`` stacked over steps along a new leading axis.
    ``max_grad_budget`` belongs to ``metric="auto"`` and is not used."""
    del max_grad_budget
    _refuse_axis_name(axis_name)
    metric_core, schedule_fn = _resolve_metric(
        metric, metric_options or {}, schedule_fn=schedule_fn
    )
    build_kernel_kwargs = {}
    if "integrator" in extra_parameters:
        # a build-time choice of HMC-family kernels, not a per-step parameter
        build_kernel_kwargs["integrator"] = extra_parameters.pop("integrator")
    mcmc_kernel = algorithm.build_kernel(**build_kernel_kwargs)
    multi_chain = n_chains > 1

    adapt_init, adapt_step, adapt_final = _make_engine(
        metric_core,
        target_acceptance_rate=target_acceptance_rate,
        pool_acceptance=multi_chain,
    )

    def run(rng_key: PRNGKey, position: ArrayLikeTree, num_steps: int = 1000):
        position = torch.as_tensor(position)
        block = position if multi_chain else torch.atleast_2d(position)
        if block.dim() != 2 or block.shape[0] != n_chains:
            expected = f"an ({n_chains}, d) block" if multi_chain else "a (d,) or (1, d) position"
            raise ValueError(f"expected {expected}, got {tuple(position.shape)}")
        state = algorithm.init(block, logdensity_fn)
        adaptation_state = adapt_init(block, initial_step_size)
        if initial_metric_state is not None:
            adaptation_state = adaptation_state._replace(
                imm_state=initial_metric_state,
                inverse_mass_matrix=initial_metric_state.inverse_mass_matrix,
            )

        outputs = []
        for stage in schedule_fn(num_steps).tolist():
            state, info = mcmc_kernel(
                rng_key,
                state,
                logdensity_fn,
                adaptation_state.step_size,
                adaptation_state.inverse_mass_matrix,
                **extra_parameters,
            )
            adaptation_state = adapt_step(
                adaptation_state,
                stage,
                state.position,
                state.logdensity_grad,
                info.acceptance_rate,
            )
            outputs.append(adaptation_info_fn(state, info, adaptation_state))

        step_size, inverse_mass_matrix = adapt_final(adaptation_state)
        parameters = {
            "step_size": step_size,
            "inverse_mass_matrix": inverse_mass_matrix,
            **extra_parameters,
        }
        info = None
        if outputs:
            info = tree_map(
                lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *outputs
            )
        return AdaptationResults(state, parameters), info

    return AdaptationAlgorithm(run)
