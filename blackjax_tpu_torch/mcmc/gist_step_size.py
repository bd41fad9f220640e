"""GIST instance: self-tuned step size (the autoStep / autoMALA family;
reference ``blackjax_tpu/mcmc/gist_step_size.py``).

The tuning parameter is ``alpha = (a, b, j)``: two acceptance thresholds
drawn uniformly on the triangle ``a < b`` and the log2 step-size index ``j``
picked by a doubling/halving search: each trial classifies the trial
trajectory's log-acceptance into a band code (+1 step too small, 0 in band,
-1 too large); the first trial's code fixes the direction, and the walk
stops as soon as a trial's code disagrees with it. Detailed balance needs
the search re-run from the proposal to land on the same index; a mismatch
or an exhausted search budget forces rejection through a ``-inf`` tuning
log-ratio.

The reference's search is a ``while_loop`` a chain (under ``vmap``). Here it
is one loop over the batch that goes on while any chain searches, a chain's
search frozen by masks once it is done: each trial integrates every chain
at its own step size, and each chain keeps its own trial count. The step
size is ``initial_step_size * 2.0 ** j`` in float32, as the reference
computes it even under x64.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import gist, hmc, integrators, trajectory
from blackjax_tpu_torch.mcmc.integrators import IntegratorState
from blackjax_tpu_torch.mcmc.proposal import safe_energy_diff
from blackjax_tpu_torch.types import Array, PRNGKey

__all__ = [
    "GISTStepSizeInfo",
    "StepSizeTuningParameter",
    "init",
    "step_size_selector",
    "build_kernel",
    "as_top_level_api",
]

init = gist.init

_CRITERIA = ("symmetric", "asymmetric")


class StepSizeTuningParameter(NamedTuple):
    """``alpha = (a, b, j)`` with ``step_size = initial_step_size * 2**j``."""

    a: Array
    b: Array
    step_index: Array


class _StepSizeExtra(NamedTuple):
    num_integration_steps: Array
    reverse_step_index: Array
    search_exhausted: Array
    step_size: Array


class GISTStepSizeInfo(NamedTuple):
    """GISTInfo fields plus the forward/reverse step indices (a ``reverse
    != forward`` mismatch is folded into ``is_accepted``), the
    search-budget-exhausted flag, and the realized step size."""

    momentum: Array
    tuning_parameter: StepSizeTuningParameter
    is_accepted: Array
    is_divergent: Array
    acceptance_rate: Array
    energy: float
    num_integration_steps: Array
    step_index: Array
    reverse_step_index: Array
    search_exhausted: Array
    step_size: Array


def _step_size(initial_step_size: float, j: Array) -> Array:
    """``initial_step_size * 2.0 ** j`` in float32 (the reference's
    ``j.astype(jnp.float32)`` makes it so under x64 too)."""
    scale = torch.pow(torch.tensor(2.0, dtype=torch.float32, device=j.device), j.to(torch.float32))
    return torch.tensor(initial_step_size, dtype=torch.float32, device=j.device) * scale


def step_size_selector(
    integrator: Callable, num_integration_steps: int,
    initial_step_size: float, max_search_steps: int = 10,
    criterion: str = "symmetric",
) -> Callable:
    """Build ``mu(state, a, b, logdensity_fn, metric) -> (step_index,
    search_exhausted)``, one a chain. ``"symmetric"`` is AutoStep Algorithm
    2's ``|ell|`` band, ``"asymmetric"`` autoMALA's signed band."""
    if criterion not in _CRITERIA:
        raise ValueError(
            f"criterion must be 'symmetric' or 'asymmetric', got {criterion!r}"
        )
    symmetric = criterion == "symmetric"

    def mu(
        state: IntegratorState, a, b, logdensity_fn, metric, *,
        build_trajectory: Optional[Callable] = None,
    ):
        if build_trajectory is None:
            one_step = integrator(logdensity_fn, metric.kinetic_energy)
            build_trajectory = trajectory.static_integration(one_step)
        energy_at_start = -state.logdensity + metric.kinetic_energy(state.momentum)
        log_a, log_b = torch.log(a), torch.log(b)

        def trial_log_accept(j):
            """ell(theta, rho, eps * 2**j) for one trial trajectory a chain."""
            eps = _step_size(initial_step_size, j)
            end = hmc.flip_momentum(build_trajectory(state, eps, num_integration_steps))
            energy_at_end = -end.logdensity + metric.kinetic_energy(end.momentum)
            return safe_energy_diff(energy_at_start, energy_at_end)

        def band_code(ell):
            if symmetric:
                too_small = torch.abs(ell) < torch.abs(log_b)
                too_large = torch.abs(ell) > torch.abs(log_a)
            else:
                too_small = ell >= log_b
                too_large = ell <= log_a
            one = torch.ones_like(ell, dtype=torch.int32)
            return torch.where(too_small, one, torch.where(too_large, -one, 0 * one))

        # the reference's walk, a chain frozen once its search is done
        batch, device = state.logdensity.shape, state.logdensity.device
        index = torch.zeros(batch, dtype=torch.int32, device=device)
        tick = torch.zeros(batch, dtype=torch.int32, device=device)
        direction = torch.zeros(batch, dtype=torch.int32, device=device)
        done = torch.zeros(batch, dtype=torch.bool, device=device)
        while True:
            searching = ~done & (tick <= max_search_steps)
            if not bool(searching.any()):
                break
            j = torch.where(searching, index + direction, index)
            code = band_code(trial_log_accept(j))
            new_direction = torch.where(tick == 0, code, direction)
            finished = (new_direction == 0) | (code != new_direction)
            index = j
            tick = torch.where(searching, tick + 1, tick)
            direction = torch.where(searching, new_direction, direction)
            done = torch.where(searching, finished, done)
        search_exhausted = ~done & (direction != 0)
        # a successful doubling run reports one index back: the last trial
        # overshot the band
        step_index = torch.where(done & (direction == 1), index - 1, index)
        return step_index, search_exhausted

    return mu


def _uniform_pair(rng_key: PRNGKey, like: torch.Tensor) -> torch.Tensor:
    """Two uniforms a chain, ``like.shape + (2,)``, in ``like``'s dtype."""
    if isinstance(rng_key, torch.Generator):
        return torch.rand(like.shape + (2,), generator=rng_key, dtype=like.dtype,
                          device=like.device)
    return prng.uniform(rng_key.to(like.device), (2,), like.dtype)


def _gibbs_draw(selector: Callable) -> Callable:
    """Draw (a, b) on the triangle and run the forward search."""

    def tuning_parameter_fn(rng_key, state, logdensity_fn, metric):
        u = _uniform_pair(rng_key, state.logdensity)
        a, b = torch.minimum(u[..., 0], u[..., 1]), torch.maximum(u[..., 0], u[..., 1])
        step_index, search_exhausted = selector(state, a, b, logdensity_fn, metric)
        return StepSizeTuningParameter(a, b, step_index), search_exhausted

    return tuning_parameter_fn


def _involution(
    integrator: Callable, num_integration_steps: int,
    initial_step_size: float, selector: Callable,
) -> Callable:
    """Integrate at the selected step size, then re-run the search from the
    proposal; the tuning log-ratio is the reversibility indicator."""

    def apply_fn(state, alpha, aux, logdensity_fn, metric):
        step_size = _step_size(initial_step_size, alpha.step_index)
        one_step = integrator(logdensity_fn, metric.kinetic_energy)
        build_trajectory = trajectory.static_integration(one_step)
        proposal = hmc.flip_momentum(build_trajectory(state, step_size, num_integration_steps))
        reverse_index, reverse_exhausted = selector(
            proposal, alpha.a, alpha.b, logdensity_fn, metric,
            build_trajectory=build_trajectory,
        )
        exhausted = aux | reverse_exhausted
        reversible = reverse_index == alpha.step_index
        zero = torch.zeros_like(state.logdensity)
        log_ratio = torch.where(reversible & ~exhausted, zero, zero - torch.inf)
        steps = torch.full(reverse_index.shape, num_integration_steps, dtype=torch.int64,
                           device=reverse_index.device)
        extra = _StepSizeExtra(steps, reverse_index, exhausted, step_size)
        return proposal, log_ratio, extra

    return apply_fn


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: float = 1000,
    criterion: str = "symmetric",
    max_search_steps: int = 10,
) -> Callable:
    """``gist_step_size`` kernel."""
    if criterion not in _CRITERIA:
        raise ValueError(
            f"criterion must be 'symmetric' or 'asymmetric', got {criterion!r}"
        )
    transition = gist.build_transition(divergence_threshold)

    def kernel(
        rng_key: PRNGKey, state: gist.GISTState, logdensity_fn: Callable,
        initial_step_size: float,
        inverse_mass_matrix: Array,
        num_integration_steps: int = 1,
    ) -> tuple[gist.GISTState, GISTStepSizeInfo]:
        selector = step_size_selector(
            integrator, num_integration_steps, initial_step_size,
            max_search_steps, criterion,
        )
        new_state, info, extra = transition(
            rng_key, state, logdensity_fn, _gibbs_draw(selector),
            _involution(integrator, num_integration_steps, initial_step_size, selector),
            inverse_mass_matrix,
        )
        return new_state, GISTStepSizeInfo(
            *info,
            info.tuning_parameter.step_index,
            extra.reverse_step_index,
            extra.search_exhausted,
            extra.step_size,
        )

    return kernel


def as_top_level_api(
    logdensity_fn: Callable, inverse_mass_matrix: Array,
    initial_step_size: float, num_integration_steps: int = 1, *,
    criterion: str = "symmetric", max_search_steps: int = 10,
    divergence_threshold: float = 1000,
    integrator: Callable = integrators.velocity_verlet,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.gist_step_size(...)``: a step size self-tuned
    each transition, with the MH correction."""
    kernel = build_kernel(integrator, divergence_threshold, criterion, max_search_steps)
    return build_sampling_algorithm(
        kernel, init, logdensity_fn,
        kernel_args=(initial_step_size, inverse_mass_matrix, num_integration_steps),
    )
