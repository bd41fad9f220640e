"""ChEES-HMC cross-chain adaptation (Hoffman, Radul & Sountsov 2021);
reference ``blackjax_tpu/adaptation/chees_adaptation.py``.

The trajectory length of jittered dynamic HMC is tuned by Adam ascent on the
ChEES criterion over an ensemble of chains, the step size by dual averaging
on the harmonic-mean acceptance rate. Optionally (``mass_matrix_estimation=
"diagonal"``) a pooled Welford estimate over the chains in the last
``mass_matrix_window_fraction`` of the warmup becomes the diagonal metric
and whitens the criterion, and (``_length_floor=True``) the consumed length
is floored at ``(pi/2) sqrt(lambda_max)`` of the whitened ensemble
covariance, tracked by warm-started power iterations.

The ensemble is one ``(C, d)`` block on the positions' device; every
cross-chain reduction runs there, and the controller's scalars are 0-d
tensors in the positions' dtype beside it (float32 positions take JAX's
32-bit rules, float64 positions its x64 ones). A step reads one number to
the host: the largest drawn step count, which bounds the trajectory's
masked loop (``trajectory.static_integration``). The step counter, the
Halton index and the Welford counts are Python ints, so the window, the
engagement gate and the floor's refresh are decided on the host without a
read. Pooling over a device mesh (``axis_name``) comes with ROADMAP queue 1,
item 12.
"""
import math
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.adaptation.base import AdaptationResults, return_all_adapt_info
from blackjax_tpu_torch.adaptation.mass_matrix import welford_algorithm
from blackjax_tpu_torch.base import AdaptationAlgorithm
from blackjax_tpu_torch.mcmc import dynamic_hmc
from blackjax_tpu_torch.optimizers import optax_twins
from blackjax_tpu_torch.optimizers.dual_averaging import _fma
from blackjax_tpu_torch.optimizers.dual_averaging import tensor_init as _da_init
from blackjax_tpu_torch.optimizers.dual_averaging import tensor_update as _da_update
from blackjax_tpu_torch.types import Array, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = ["ChEESAdaptationState", "base", "chees_adaptation"]

OPTIMAL_TARGET_ACCEPTANCE_RATE = 0.651
EPS_FLOAT = 1e-10
LOG_UPDATE_CLIP = 1.0

# the slow-direction floor: a whitened direction of eigenvalue lambda turns a
# quarter in (pi/2) sqrt(lambda); lambda_max refreshed every INTERVAL steps
CHEES_LENGTH_FLOOR_FACTOR: float = math.pi / 2
_LENGTH_FLOOR_RECOMPUTE_INTERVAL = 32
_LENGTH_FLOOR_POWER_ITERATIONS = 5
_LENGTH_FLOOR_FINAL_POWER_ITERATIONS = 20
_LENGTH_FLOOR_LAMBDA_EPS = 1e-6


_MESH = "axis_name (pooling over devices) is not ported yet: ROADMAP queue 1, item 12"


class _ChEESEigState(NamedTuple):
    """The warm-startable top eigenpair of the whitened ensemble covariance
    ``D^{-1/2} C D^{-1/2}`` (D the engaged diagonal metric)."""

    eigenvector: Array
    lambda_max: Array


class ChEESAdaptationState(NamedTuple):
    step_size: Array
    log_step_size_moving_average: Array
    trajectory_length: Array
    log_trajectory_length_moving_average: Array
    da_state: NamedTuple
    optim_state: NamedTuple
    random_generator_arg: int
    step: int


def _eig_state_init(num_dim: int, *, dtype=None, device=None) -> _ChEESEigState:
    ones = torch.ones(num_dim, dtype=dtype, device=device)
    return _ChEESEigState(ones / math.sqrt(num_dim), torch.ones((), dtype=dtype, device=device))


def _power_iteration_lambda_max(matrix, v0, num_iterations: int):
    """Warm-started power iteration on a symmetric PSD matrix: the Rayleigh
    quotient and the normalised direction (to warm-start the next
    refresh)."""
    v = v0
    for _ in range(num_iterations):
        v_next = matrix @ v
        norm = torch.linalg.vector_norm(v_next)
        v = v_next / torch.where(norm > 0.0, norm, torch.ones_like(norm))
    return torch.dot(v, matrix @ v), v


def _recompute_eig_state(cov_count, cov_mean, cov_m2, inverse_mass_matrix, eig_state,
                         num_iterations: int) -> _ChEESEigState:
    """Whiten the pooled dense covariance by the engaged diagonal metric and
    refresh the top eigenvalue."""
    del cov_mean
    covariance = cov_m2 / max(float(cov_count) - 1.0, 1.0)
    inv_sqrt_d = 1.0 / torch.sqrt(inverse_mass_matrix)
    whitened = covariance * inv_sqrt_d[:, None] * inv_sqrt_d[None, :]
    lambda_max, eigenvector = _power_iteration_lambda_max(
        whitened, eig_state.eigenvector, num_iterations)
    return _ChEESEigState(eigenvector, torch.clamp(lambda_max, min=_LENGTH_FLOOR_LAMBDA_EPS))


def _apply_length_floor(trajectory_length, lambda_max, engaged, enable: bool,
                        max_leapfrog_steps: int, step_size):
    """Floor the consumed length at ``(pi/2) sqrt(lambda_max)`` where the
    metric is engaged, capped at ``max_leapfrog_steps * step_size``; never
    fed back into the optimizer. Returns ``(consumed_length,
    floor_clipped_by_cap)``."""
    engaged = torch.as_tensor(engaged, device=trajectory_length.device)
    if not enable:
        return trajectory_length, torch.zeros((), dtype=torch.bool,
                                              device=trajectory_length.device)
    floor_value = torch.where(engaged, CHEES_LENGTH_FLOOR_FACTOR * torch.sqrt(lambda_max),
                              torch.zeros_like(lambda_max))
    cap = max_leapfrog_steps * step_size
    consumed = torch.minimum(torch.maximum(trajectory_length, floor_value), cap)
    return consumed, engaged & (floor_value > cap)


def _weighted_mean(x, w):
    return (x * w[:, None]).sum(0) / (w.sum() + EPS_FLOAT)


def _axis_nanmean(x):
    """``nanmean`` over the chains: NaN masked, +-inf counted."""
    counted = ~torch.isnan(x)
    return torch.where(counted, x, torch.zeros_like(x)).sum(0) / counted.sum(0)


def _masked_sum(x, keep):
    """``jnp.sum(x, where=keep)``."""
    return torch.where(keep, x, torch.zeros_like(x)).sum()


def _select(ok, new, old):
    """``jnp.where(ok, new, old)`` leafwise over a state."""
    return tree_map(lambda a, b: torch.where(ok, a, b), new, old)


def base(
    jitter_generator: Callable,
    next_random_arg_fn: Callable,
    optim: optax_twins.GradientTransformation,
    target_acceptance_rate: float,
    decay_rate: float,
    max_leapfrog_steps: int,
    whiten_criterion: bool = True,
    axis_name: Optional[str] = None,
) -> tuple[Callable, Callable]:
    """``(init, update)`` of the ChEES controller.

    ``init(random_generator_arg, step_size)`` takes the step size as a 0-d
    tensor of the ensemble's dtype and device (or a number, then float32 on
    the CPU). ``update`` takes one ensemble step's proposals (positions,
    momenta, ``(C, d)``), the initial positions, the per-chain acceptance
    probabilities and divergence flags, and the diagonal inverse mass matrix
    the kernel used; with a non-identity metric the criterion is whitened
    (``whiten_criterion``), with the identity every factor is exact."""
    if axis_name is not None:
        raise NotImplementedError(_MESH)

    def init(random_generator_arg, step_size) -> ChEESAdaptationState:
        step_size = torch.as_tensor(step_size)
        zero = torch.zeros_like(step_size)
        return ChEESAdaptationState(
            step_size=step_size,
            log_step_size_moving_average=zero,
            trajectory_length=step_size,
            log_trajectory_length_moving_average=zero,
            da_state=_da_init(step_size),
            optim_state=optim.init(step_size),
            random_generator_arg=random_generator_arg,
            step=1,
        )

    def update(
        state: ChEESAdaptationState,
        proposed_positions: Array,
        proposed_momentums: Array,
        initial_positions: Array,
        acceptance_probabilities: Array,
        is_divergent: Array,
        inverse_mass_matrix: Array,
    ) -> ChEESAdaptationState:
        keep = ~is_divergent
        # ---- step size: dual averaging on the harmonic-mean acceptance ----
        inv_acc_sum = _masked_sum(1.0 / acceptance_probabilities, keep)
        harmonic_mean = keep.sum() / inv_acc_sum
        harmonic_mean = torch.where(torch.isfinite(harmonic_mean), harmonic_mean,
                                    torch.zeros_like(harmonic_mean))
        da_candidate = _da_update(state.da_state, target_acceptance_rate - harmonic_mean)
        candidate_step_size = torch.exp(da_candidate.log_x)
        ok = torch.isfinite(candidate_step_size)
        new_step_size = torch.where(ok, candidate_step_size, state.step_size)
        new_da_state = _select(ok, da_candidate, state.da_state)
        new_log_step_size = torch.where(ok, da_candidate.log_x, state.da_state.log_x)

        update_weight = state.step ** (-decay_rate)
        new_log_step_size_ma = _fma(state.log_step_size_moving_average, 1.0 - update_weight,
                                    update_weight * new_log_step_size)

        # ---- trajectory length: ascent on the ChEES gradient ----
        w = torch.where(keep, acceptance_probabilities, torch.zeros_like(acceptance_probabilities))
        proposals_centered = proposed_positions - _weighted_mean(proposed_positions, w)
        initials_centered = initial_positions - _axis_nanmean(initial_positions)
        if whiten_criterion:
            inv_sqrt_imm = 1.0 / torch.sqrt(inverse_mass_matrix)
            proposals_w = proposals_centered * inv_sqrt_imm
            initials_w = initials_centered * inv_sqrt_imm
            # the velocity v = Sigma p, whitened like a position's tangent
            velocities_w = proposed_momentums * inverse_mass_matrix * inv_sqrt_imm
        else:
            proposals_w, initials_w = proposals_centered, initials_centered
            velocities_w = proposed_momentums
        per_chain_gradients = (
            (proposals_w * proposals_w).sum(-1) - (initials_w * initials_w).sum(-1)
        ) * (proposals_w * velocities_w).sum(-1)
        trajectory_gradients = (
            jitter_generator(state.random_generator_arg)
            * state.trajectory_length  # the gradient in the LOG trajectory length
            * per_chain_gradients
        )
        trajectory_gradient = _masked_sum(
            acceptance_probabilities * trajectory_gradients, keep
        ) / _masked_sum(acceptance_probabilities + EPS_FLOAT, keep)

        log_length = torch.log(state.trajectory_length)
        updates, optim_candidate = optim.update(trajectory_gradient, state.optim_state,
                                                log_length)
        updates = tree_map(lambda u: torch.clamp(u, -LOG_UPDATE_CLIP, LOG_UPDATE_CLIP), updates)
        log_length_candidate = optax_twins.apply_updates(log_length, updates)
        length_ok = torch.isfinite(log_length_candidate).all()
        new_log_length = torch.where(length_ok, log_length_candidate, log_length)
        new_optim_state = _select(length_ok, optim_candidate, state.optim_state)

        new_log_length_ma = _fma(state.log_trajectory_length_moving_average,
                                 1.0 - update_weight, update_weight * new_log_length)
        new_trajectory_length = torch.minimum(
            torch.maximum(torch.exp(new_log_length_ma), new_step_size),
            max_leapfrog_steps * new_step_size,
        )
        return ChEESAdaptationState(
            new_step_size,
            new_log_step_size_ma,
            new_trajectory_length,
            new_log_length_ma,
            new_da_state,
            new_optim_state,
            next_random_arg_fn(state.random_generator_arg),
            state.step + 1,
        )

    return init, update


def chees_adaptation(
    logdensity_fn: Callable,
    num_chains: int,
    *,
    jitter_generator: Optional[Callable] = None,
    jitter_amount: float = 1.0,
    target_acceptance_rate: float = OPTIMAL_TARGET_ACCEPTANCE_RATE,
    decay_rate: float = 0.5,
    max_leapfrog_steps: int = 1000,
    adaptation_info_fn: Callable = return_all_adapt_info,
    mass_matrix_estimation: Optional[str] = None,
    mass_matrix_window_fraction: float = 0.5,
    _length_floor: bool = False,
    axis_name: Optional[str] = None,
    integration_unroll: int = 2,
) -> AdaptationAlgorithm:
    """Cross-chain ChEES warmup for jittered dynamic HMC.

    ``run(rng_key, positions, step_size, optim, num_steps=1000, *,
    max_sampling_steps=1000)`` takes ``(num_chains, d)`` positions, the
    initial step size, an :func:`~blackjax_tpu_torch.optimizers.optax_twins
    .adam` and the key words of one key (or a ``torch.Generator``, from which
    one key is drawn); it runs on the positions' device and returns
    ``(AdaptationResults(last_states, parameters), info)``, ``info`` the
    ``adaptation_info_fn`` records stacked over the steps. The parameters are
    those ``dynamic_hmc`` takes: ``step_size`` and
    ``integration_steps_params`` as 0-d tensors.

    The trajectory lengths are jittered by the base-2 Halton sequence over
    ``ceil(log2(num_steps + max_sampling_steps))`` bits, or by
    ``jitter_generator(fold_in(key, i))`` (``jitter_amount`` scales either).
    ``mass_matrix_estimation="diagonal"`` pools a Welford estimate over the
    chains in the last ``mass_matrix_window_fraction`` of the warmup, gated
    on ``max(64, 2 sqrt(d))`` samples, and whitens the criterion with it;
    ``_length_floor=True`` (with the diagonal metric) also floors the
    consumed length (see the module's head). ``integration_unroll`` only
    blocks the reference's trajectory loop and has no effect here.
    """
    if mass_matrix_estimation not in (None, "diagonal"):
        raise ValueError(
            f"mass_matrix_estimation must be None or 'diagonal', got "
            f"{mass_matrix_estimation!r}."
        )
    if not 0.0 <= mass_matrix_window_fraction <= 1.0:
        raise ValueError(
            "mass_matrix_window_fraction must be in [0, 1], got "
            f"{mass_matrix_window_fraction}."
        )
    estimate_mass_matrix = mass_matrix_estimation == "diagonal"
    if _length_floor and not estimate_mass_matrix:
        raise ValueError(
            "_length_floor=True requires mass_matrix_estimation='diagonal' "
            "(the floor shares the diagonal metric's engagement gate)."
        )
    if axis_name is not None:
        raise NotImplementedError(_MESH)

    def run(
        rng_key: PRNGKey,
        positions: Array,
        step_size,
        optim: optax_twins.GradientTransformation,
        num_steps: int = 1000,
        *,
        max_sampling_steps: int = 1000,
    ):
        if not torch.is_tensor(positions) or positions.dim() != 2:
            raise ValueError(
                "chees_adaptation takes (num_chains, d) tensor positions: pytree positions "
                "come with ROADMAP queue 1, item 11"
            )
        assert positions.shape[0] == num_chains, (
            "initial `positions` leading dimension must equal the chain count"
        )
        device, dtype = positions.device, positions.dtype
        int_dtype = prng.default_int_dtype(dtype)
        num_dim = positions.shape[1]
        if isinstance(rng_key, torch.Generator):
            rng_key = prng.from_generator(rng_key, (), device)
        rng_key = rng_key.to(device)

        def next_random_arg_fn(i):
            return i + 1

        def const(value):
            return torch.as_tensor(value, dtype=dtype, device=device)

        shift, scale = const(1.0 - jitter_amount), const(jitter_amount)

        def jittered(unit):
            # unit * amount + (1 - amount), one multiply-add as XLA contracts it
            return torch.addcmul(shift, unit.to(dtype), scale)

        if jitter_generator is not None:
            rng_key, carry_key = prng.split(rng_key).unbind(-2)

            def jitter_gn(i):
                i = torch.as_tensor(i, dtype=int_dtype, device=device)
                return jittered(jitter_generator(prng.fold_in(carry_key, i)))
        else:
            max_bits = int(math.ceil(math.log2(num_steps + max_sampling_steps)))

            def jitter_gn(i):
                i = torch.as_tensor(i, dtype=int_dtype, device=device)
                return jittered(dynamic_hmc.halton_sequence(i, max_bits))

        def integration_steps_fn(random_generator_arg, num_leapfrog_steps):
            return torch.ceil(jitter_gn(random_generator_arg) * num_leapfrog_steps).to(int_dtype)

        step_fn = dynamic_hmc.build_kernel(
            next_random_arg_fn=next_random_arg_fn,
            integration_steps_fn=integration_steps_fn,
            integration_unroll=integration_unroll,
        )
        init, update = base(jitter_gn, next_random_arg_fn, optim, target_acceptance_rate,
                            decay_rate, max_leapfrog_steps)

        wc_init, wc_update, wc_final = welford_algorithm(is_diagonal_matrix=True)
        dense_init, dense_update, _ = welford_algorithm(is_diagonal_matrix=False)
        engagement_threshold = max(64, int(2 * math.sqrt(num_dim)))
        window_start = int(num_steps * mass_matrix_window_fraction)
        ones = torch.ones(num_dim, dtype=dtype, device=device)

        def current_imm(mm_accum):
            if not estimate_mass_matrix:
                return ones
            cov, _, _ = wc_final(mm_accum)
            if mm_accum.sample_size < engagement_threshold:
                return ones
            return torch.where(torch.isfinite(cov) & (cov > 0), cov, ones)

        states = dynamic_hmc.init(positions, logdensity_fn,
                                  torch.zeros(num_chains, dtype=int_dtype, device=device))
        adaptation_state = init(0, const(step_size))
        mm_accum = wc_init(num_dim if estimate_mass_matrix else 1, dtype=dtype, device=device)
        dense_accum = dense_init(num_dim if _length_floor else 1, dtype=dtype, device=device)
        eig_state = _eig_state_init(num_dim, dtype=dtype, device=device)

        outputs = []
        for step_idx, key in enumerate(prng.split(rng_key, num_steps)):
            in_window = step_idx >= window_start
            imm = current_imm(mm_accum)
            engaged = mm_accum.sample_size >= engagement_threshold
            consumed_length, _ = _apply_length_floor(
                adaptation_state.trajectory_length, eig_state.lambda_max, engaged,
                _length_floor, max_leapfrog_steps, adaptation_state.step_size)
            # the kernel's masked trajectory loop reads the largest drawn
            # count to the host: the step's one read
            new_states, info = step_fn(
                prng.split(key, num_chains), states, logdensity_fn,
                adaptation_state.step_size, imm,
                (consumed_length / adaptation_state.step_size,))
            adaptation_state = update(
                adaptation_state, info.proposal.position, info.proposal.momentum,
                states.position, info.acceptance_rate, info.is_divergent, imm)
            if estimate_mass_matrix and in_window:
                mm_accum = wc_update(mm_accum, new_states.position)
            if _length_floor and in_window:
                dense_accum = dense_update(dense_accum, new_states.position)
                if engaged and step_idx % _LENGTH_FLOOR_RECOMPUTE_INTERVAL == 0:
                    eig_state = _recompute_eig_state(
                        dense_accum.sample_size, dense_accum.mean, dense_accum.m2, imm,
                        eig_state, _LENGTH_FLOOR_POWER_ITERATIONS)
            states = new_states
            outputs.append(adaptation_info_fn(states, info, adaptation_state))

        final_imm = current_imm(mm_accum)
        final_step_size = torch.exp(adaptation_state.log_step_size_moving_average)
        final_length = torch.exp(adaptation_state.log_trajectory_length_moving_average)
        if _length_floor:
            # a longer final refresh, so the parameters see a converged lambda_max
            final_eig_state = _recompute_eig_state(
                dense_accum.sample_size, dense_accum.mean, dense_accum.m2, final_imm,
                eig_state, _LENGTH_FLOOR_FINAL_POWER_ITERATIONS)
            final_length, _ = _apply_length_floor(
                final_length, final_eig_state.lambda_max,
                mm_accum.sample_size >= engagement_threshold, _length_floor,
                max_leapfrog_steps, final_step_size)
        parameters = {
            "step_size": final_step_size,
            "inverse_mass_matrix": final_imm,
            "next_random_arg_fn": next_random_arg_fn,
            "integration_steps_fn": integration_steps_fn,
            "integration_steps_params": (final_length / final_step_size,),
        }
        info = None
        if outputs:
            info = tree_map(lambda *xs: torch.stack([torch.as_tensor(x, device=device)
                                                     for x in xs]), *outputs)
        return AdaptationResults(states, parameters), info

    return AdaptationAlgorithm(run)
