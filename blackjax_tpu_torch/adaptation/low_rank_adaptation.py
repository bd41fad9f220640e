"""Low-rank window adaptation: the staged warmup engine with nutpie's
Fisher-divergence low-rank metric, its 1.5x-growing window schedule and its
partial-forget buffer (reference
``blackjax_tpu/adaptation/low_rank_adaptation.py``)."""
from typing import Callable

import numpy as np
import torch

from blackjax_tpu_torch.adaptation.base import AdaptationInfo, AdaptationResults
from blackjax_tpu_torch.adaptation.metric_recipes import (
    LowRankMetricCoreState,
    _build_fisher_low_rank_accumulating_core,
    _build_fisher_low_rank_core,
    seed_low_rank_sigma_from_grad,
)
from blackjax_tpu_torch.adaptation.staged_adaptation import build_schedule, staged_adaptation
from blackjax_tpu_torch.base import AdaptationAlgorithm
from blackjax_tpu_torch.mcmc import integrators as mcmc_integrators
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey

__all__ = ["window_adaptation_low_rank", "build_growing_window_schedule"]


def build_growing_window_schedule(
    num_steps: int,
    early_window: float = 0.3,
    step_size_window: float = 0.15,
    early_window_size: int = 10,
    window_size: int = 80,
    window_growth: float = 1.5,
) -> Array:
    """nutpie's schedule as a ``(num_steps, 2)`` int64 tensor of ``(stage,
    is_middle_window_end)``: small fixed early windows, then main windows
    that grow by ``window_growth`` (a window whose grown successor would not
    fit absorbs all remaining slow steps), then a step-size-only phase. The
    metric adapts from the first draw: there is no initial fast buffer."""
    schedule = []
    if num_steps < 20:
        schedule = [(0, False)] * num_steps
    else:
        final_buffer_size = max(int(round(step_size_window * num_steps)), 1)
        final_buffer_start = num_steps - final_buffer_size
        early_end = min(max(int(round(early_window * num_steps)), 1), final_buffer_start)
        pos = 0
        while pos < early_end:
            size = min(early_window_size, early_end - pos)
            schedule += [(1, False)] * (size - 1) + [(1, True)]
            pos += size
        current_size = window_size
        while pos < final_buffer_start:
            remaining = final_buffer_start - pos
            next_size = max(current_size + 1, int(round(current_size * window_growth)))
            if (pos + current_size) + next_size > final_buffer_start:
                # late: absorb everything remaining into this window
                schedule += [(1, False)] * (remaining - 1) + [(1, True)]
                pos += remaining
                break
            schedule += [(1, False)] * (current_size - 1) + [(1, True)]
            pos += current_size
            current_size = next_size
        schedule += [(0, False)] * (num_steps - pos)
    return torch.tensor(schedule, dtype=torch.int64).reshape(-1, 2)


def _accumulating_buffer_capacity(schedule: Array) -> int:
    """The partial-forget buffer's capacity: the largest sum of two
    consecutive windows (or the first window alone)."""
    is_end = np.asarray(schedule)[:, 1].astype(bool)
    ends = np.flatnonzero(is_end)
    if ends.size == 0:
        return 1
    window_sizes = np.diff(np.concatenate([[-1], ends]))
    if window_sizes.size == 1:
        return int(window_sizes[0])
    pair_sums = window_sizes[1:] + window_sizes[:-1]
    return int(max(window_sizes[0], pair_sums.max()))


def _default_low_rank_adaptation_info_fn(state, info, adaptation_state):
    """Drop the ``(buffer_size, d)`` working buffers from each step's info,
    which would otherwise be kept once per step."""
    imm_state: LowRankMetricCoreState = adaptation_state.imm_state
    slim = imm_state._replace(draws_buffer=None, grads_buffer=None)
    return AdaptationInfo(state, info, adaptation_state._replace(imm_state=slim))


def window_adaptation_low_rank(
    algorithm,
    logdensity_fn: Callable,
    max_rank: int = 10,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.80,
    gamma: float = 1e-5,
    cutoff: float = 2.0,
    adaptation_info_fn: Callable = _default_low_rank_adaptation_info_fn,
    integrator=mcmc_integrators.velocity_verlet,
    gradient_based_init: bool = False,
    schedule_fn: Callable = build_schedule,
    buffer_policy: str = "reset",
    recompute_every: int = 1,
    **extra_parameters,
) -> AdaptationAlgorithm:
    """Adapt ``(step_size, LowRankInverseMassMatrix)`` for an HMC-family
    algorithm. ``buffer_policy="accumulating"`` with
    ``schedule_fn=build_growing_window_schedule`` is nutpie's warmup. The
    returned state restarts the chain at the optimal translation ``mu* =
    mean(x) + sigma^2 mean(grad)`` of the last recompute, shaped like the
    given position; ``adaptation_info_fn`` must keep
    ``adaptation_state.imm_state.mu_star``, as the default does."""
    if buffer_policy not in ("reset", "accumulating"):
        raise ValueError(
            f"buffer_policy must be 'reset' or 'accumulating', got {buffer_policy!r}"
        )
    if recompute_every < 1:
        raise ValueError(f"recompute_every must be >= 1, got {recompute_every!r}")

    def run(rng_key: PRNGKey, position: ArrayLikeTree, num_steps: int = 1000):
        position = torch.as_tensor(position)
        if buffer_policy == "accumulating":
            schedule = schedule_fn(num_steps)
            buffer_size = max(_accumulating_buffer_capacity(schedule), 1)
            effective_schedule_fn = lambda n: schedule  # noqa: E731
            core = _build_fisher_low_rank_accumulating_core(
                buffer_size=buffer_size,
                max_rank=max_rank,
                gamma=gamma,
                cutoff=cutoff,
                recompute_every=recompute_every,
            )
        else:
            # the buffer holds the expected largest slow window; a window
            # that overflows it keeps its newest draws
            typical_window = max(num_steps // 5, 128)
            buffer_size = min(typical_window * 2, max(num_steps, 1))
            effective_schedule_fn = schedule_fn
            core = _build_fisher_low_rank_core(
                buffer_size=buffer_size, max_rank=max_rank, gamma=gamma, cutoff=cutoff
            )

        seeded_imm_state = None
        if gradient_based_init:
            init_state = algorithm.init(position, logdensity_fn)
            seeded_imm_state = seed_low_rank_sigma_from_grad(
                core.init(position.shape[-1], dtype=position.dtype, device=position.device),
                init_state.logdensity_grad,
            )

        engine = staged_adaptation(
            algorithm,
            logdensity_fn,
            metric=core,
            initial_step_size=initial_step_size,
            target_acceptance_rate=target_acceptance_rate,
            adaptation_info_fn=adaptation_info_fn,
            schedule_fn=effective_schedule_fn,
            initial_metric_state=seeded_imm_state,
            integrator=integrator,
            **extra_parameters,
        )
        results, info = engine.run(rng_key, position, num_steps)

        # restart the chain at mu* (optimal translation, paper section 3.2)
        mu_star = info.adaptation_state.imm_state.mu_star[-1]
        mu_star_state = algorithm.init(mu_star.reshape(position.shape), logdensity_fn)
        return AdaptationResults(mu_star_state, results.parameters), info

    return AdaptationAlgorithm(run)
