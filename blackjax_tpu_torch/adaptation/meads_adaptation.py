"""MEADS: Maximum-Eigenvalue Adaptation of Damping and Step size for
generalized HMC (Hoffman & Sountsov 2022, Algorithm 3); reference
``blackjax_tpu/adaptation/meads_adaptation.py``.

The chains are split into K folds. At step t fold ``t mod K`` is frozen,
each fold samples with the step size and momentum scale its left neighbour's
chains give (the largest eigenvalue of their preconditioned gradients), its
damping comes from its own positions, and every K steps the chains are
reshuffled across the folds. With ``low_rank_rank=k`` (MEADS-LRD) one rank-k
low-rank metric, pooled over every chain in a window at the end of the
warmup, replaces the per-fold diagonal scales; the damping is whitened by
it, the step size is not.

The ensemble is one ``(C, d)`` block on the positions' device, and the four
folds' statistics are batched ``(K, n, d)`` products there. The step
counter, the frozen fold, the reshuffle steps, the LRD window and its
``count >= 2d`` gate follow from Python integers, so a step reads nothing
back from the device (but for MEADS-LRD's window steps, whose ``eigh`` waits
for its status). Pooling over a device mesh (``axis_name``, the reference's
sharded path) comes with ROADMAP queue 1, item 12.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.adaptation.base import AdaptationResults, return_all_adapt_info
from blackjax_tpu_torch.adaptation.chees_adaptation import _MESH
from blackjax_tpu_torch.adaptation.metric_buffers import MomentBlock, cgl_update_batch
from blackjax_tpu_torch.adaptation.metric_estimators import sample_covariance_eigh_low_rank
from blackjax_tpu_torch.base import AdaptationAlgorithm
from blackjax_tpu_torch.mcmc import ghmc
from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix, _low_rank_matvec
from blackjax_tpu_torch.types import Array
from blackjax_tpu_torch.util import tree_map

__all__ = ["MEADSAdaptationState", "base", "meads_adaptation", "maximum_eigenvalue"]

# a rank-deficient ensemble can give lam ~ 0 (or slightly negative from an
# f32 eigh), whose square root is NaN in the whitening
_LRD_EIGENVALUE_FLOOR = 1e-6


def _mean(x: Array, dim: int) -> Array:
    """``jnp.mean``: the sum over ``dim`` divided by its length."""
    return x.sum(dim) / x.shape[dim]


def _population_std(x: Array, dim: int) -> Array:
    """The standard deviation over ``dim`` with ``ddof = 0``, as the
    reference's ``std`` and ``_ensemble_std`` take it (``torch.std``'s
    default divides by ``n - 1``)."""
    return torch.sqrt(_mean((x - _mean(x, dim).unsqueeze(dim)) ** 2, dim))


def _low_rank_precondition_pos(pos, sigma, U, lam):
    """``M^{1/2} pos`` for the low-rank metric, over the rows of ``pos``;
    ``pos / sigma`` at ``lam = 1``."""
    return _low_rank_matvec(pos, U, 1.0 / torch.sqrt(lam)) / sigma


def _lrd_diagonal_fallback(ensemble_sigma: Array, k: int):
    """Before the window (or the gate) opens: a purely diagonal metric, the
    ensemble's standard deviations with ``lam = 1`` (any orthonormal ``U``
    then multiplies a zero coefficient)."""
    sigma = torch.where(ensemble_sigma <= 0.0, torch.ones_like(ensemble_sigma), ensemble_sigma)
    d = ensemble_sigma.shape[-1]
    like = dict(dtype=ensemble_sigma.dtype, device=ensemble_sigma.device)
    return sigma, torch.eye(d, k, **like), torch.ones((k,), **like)


class MEADSAdaptationState(NamedTuple):
    """The per-fold GHMC parameters; ``current_iteration`` a Python int."""

    current_iteration: int
    step_size: Array  # (num_folds,)
    position_sigma: Array  # (num_folds, d)
    alpha: Array
    delta: Array


def maximum_eigenvalue(matrix: Array, axis_name: Optional[str] = None,
                       axis_index_groups=None) -> Array:
    """A low-variance estimate of the largest eigenvalue of the second-moment
    matrix of a batch of vectors, the ratio ``E[sum lambda_i^2] / E[sum
    lambda_i]``, of each ``(n, d)`` batch in ``matrix`` (``(..., n, d)``;
    folds stacked on the leading axes are one batched product).

    Two evaluations of the same number (``sum(gram^2) - sum(diag^2) =
    ||X^T X||_F^2 - sum_i ||x_i||^4``): the ``(n, n)`` Gram form when
    ``n <= d``, the ``(d, d)`` covariance form otherwise, as the reference
    picks them."""
    if axis_name is not None:
        raise NotImplementedError(_MESH)
    X = torch.as_tensor(matrix)
    if X.dim() < 2:
        raise ValueError(f"maximum_eigenvalue takes (..., n, d) batches, got {tuple(X.shape)}")
    n, d = X.shape[-2:]
    if n <= d:
        gram = X @ X.transpose(-1, -2)
        diag = torch.diagonal(gram, dim1=-2, dim2=-1)
        first_moment = diag.sum(-1) / n
        second_moment = ((gram**2).sum((-2, -1)) - (diag**2).sum(-1)) / (n * (n - 1))
        return second_moment / first_moment
    C = X.transpose(-1, -2) @ X  # the (unnormalised) second-moment matrix
    row_sq = (X**2).sum(-1)
    first_moment = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / n
    second_moment = ((C**2).sum((-2, -1)) - (row_sq**2).sum(-1)) / (n * (n - 1))
    return second_moment / first_moment


def _damping(centered, epsilon, current_iteration: int, damping_slowdown: float):
    """Algorithm 3, lines 9-10: the damping from the slowest direction of
    the (whitened, centred) ensemble, floored early in the run; returns
    ``(alpha, delta)``."""
    gamma = torch.maximum(
        1.0 / torch.sqrt(maximum_eigenvalue(centered)),
        damping_slowdown / ((current_iteration + 1) * epsilon),
    )
    alpha = 1.0 - torch.exp(-2.0 * epsilon * gamma)
    return alpha, alpha / 2.0


def _step_size(scaled_grads, step_size_multiplier: float):
    """Algorithm 3, line 8: the step size from the largest curvature of the
    preconditioned gradients, at most 1."""
    return torch.clamp(
        step_size_multiplier / torch.sqrt(maximum_eigenvalue(scaled_grads)), max=1.0)


def base(num_folds: int = 4, step_size_multiplier: float = 0.5,
         damping_slowdown: float = 1.0, axis_name: Optional[str] = None):
    """``(init, update)`` of the MEADS controller over per-fold parameters,
    from ``(C, d)`` positions and their log-density gradients.
    ``update(state, positions, logdensity_grad, source_fold)`` writes the
    parameters of ``source_fold``'s chains into the slot of fold
    ``source_fold + 1``."""
    if num_folds < 1:
        raise ValueError(f"num_folds must be >= 1, got {num_folds}.")
    if axis_name is not None:
        raise NotImplementedError(_MESH)

    def compute_parameters(positions, logdensity_grad, current_iteration):
        mean_position = _mean(positions, 0)
        sd_position = _population_std(positions, 0)
        normalized = (positions - mean_position) / sd_position
        epsilon = _step_size(logdensity_grad * sd_position, step_size_multiplier)
        alpha, delta = _damping(normalized, epsilon, current_iteration, damping_slowdown)
        return epsilon, sd_position, alpha, delta

    def init(positions: Array, logdensity_grad: Array) -> MEADSAdaptationState:
        step_size, sd_position, alpha, delta = compute_parameters(positions, logdensity_grad, 0)
        return MEADSAdaptationState(
            0,
            step_size.expand(num_folds).clone(),
            sd_position.expand(num_folds, -1).clone(),
            alpha.expand(num_folds).clone(),
            delta.expand(num_folds).clone(),
        )

    def update(adaptation_state: MEADSAdaptationState, positions: Array,
               logdensity_grad: Array, source_fold: int) -> MEADSAdaptationState:
        target = (source_fold + 1) % num_folds
        t = adaptation_state.current_iteration
        new = compute_parameters(positions, logdensity_grad, t)
        rows = []
        for old, value in zip(adaptation_state[1:], new):
            row = old.clone()
            row[target] = value
            rows.append(row)
        return MEADSAdaptationState(t + 1, *rows)

    return init, update


def meads_adaptation(
    logdensity_fn: Callable,
    num_chains: int,
    num_folds: int = 4,
    step_size_multiplier: float = 0.5,
    damping_slowdown: float = 1.0,
    adaptation_info_fn: Callable = return_all_adapt_info,
    low_rank_rank: Optional[int] = None,
    low_rank_window_fraction: float = 0.5,
    axis_name: Optional[str] = None,
) -> AdaptationAlgorithm:
    """Cross-chain MEADS warmup for GHMC.

    ``run(rng_key, positions, num_steps=1000)`` takes ``(num_chains, d)``
    positions and the key words of one key (or a ``torch.Generator``, from
    which one key is drawn); it runs on the positions' device and returns
    ``(AdaptationResults(last_states, parameters), info)``, ``info`` the
    ``adaptation_info_fn`` records stacked over the steps. ``parameters``
    holds what ``ghmc`` takes: ``step_size``, ``alpha`` and ``delta`` (each
    the mean over the folds, a 0-d tensor) and ``momentum_inverse_scale``,
    the mean over the folds of their scales, or with ``low_rank_rank=k`` one
    :class:`LowRankInverseMassMatrix`.

    MEADS-LRD (``low_rank_rank=k``) estimates that metric from a covariance
    accumulated over every chain in the last ``low_rank_window_fraction`` of
    the warmup, once it holds ``2 d`` draws (before, a diagonal fallback);
    ``k`` is clamped to ``num_chains - 1`` here and to ``d`` by the first
    ``run``, and the clamp stays for later runs, as in the reference."""
    if num_folds < 1:
        raise ValueError(f"num_folds must be >= 1, got {num_folds}.")
    if num_chains % num_folds != 0:
        raise ValueError(
            f"num_chains ({num_chains}) must be divisible by num_folds ({num_folds})."
        )
    n_per_fold = num_chains // num_folds

    low_rank_k: Optional[int] = None
    if low_rank_rank is not None:
        low_rank_k = min(low_rank_rank, num_chains - 1)
        if low_rank_k < 1:
            raise ValueError(
                f"low_rank_rank={low_rank_rank} needs num_chains - 1 >= 1 "
                f"(got num_chains={num_chains})."
            )
        if not 0.0 <= low_rank_window_fraction <= 1.0:
            raise ValueError(
                "low_rank_window_fraction must be in [0, 1], got "
                f"{low_rank_window_fraction}."
            )
    if axis_name is not None:
        raise NotImplementedError(_MESH)

    ghmc_kernel = ghmc.build_kernel()
    adapt_init, _ = base(num_folds, step_size_multiplier, damping_slowdown)

    def per_chain(x):
        """A per-fold ``(K, ...)`` value repeated for each chain of its fold."""
        return x.unsqueeze(1).expand((num_folds, n_per_fold) + x.shape[1:]).reshape(
            (num_chains,) + x.shape[1:])

    def global_lrd(accum: MomentBlock, accum_count: int, positions, in_window: bool):
        """The shared ``(sigma, U, lam)``: the accumulated covariance's eigh
        once the window holds ``2 d`` draws, else the diagonal fallback."""
        if in_window and accum_count >= 2 * positions.shape[-1]:
            sigma, U, lam = sample_covariance_eigh_low_rank(accum.m2, accum.count, low_rank_k)
        else:
            sigma, U, lam = _lrd_diagonal_fallback(_population_std(positions, 0), low_rank_k)
        return sigma, U, torch.clamp(lam, min=_LRD_EIGENVALUE_FLOOR)

    def one_step(key, states, adaptation_state, accum, accum_count, in_window):
        t = adaptation_state.current_iteration
        d = states.position.shape[1]
        keys = prng.split(key, num_chains + 1)
        chain_keys, shuffle_key = keys[:num_chains], keys[num_chains]

        folded_pos = states.position.reshape(num_folds, n_per_fold, d)
        folded_grads = states.logdensity_grad.reshape(num_folds, n_per_fold, d)
        folded_scales = _population_std(folded_pos, 1)  # (K, d)
        step_size_own = _step_size(folded_grads * folded_scales[:, None, :],
                                   step_size_multiplier)
        # fold k samples with the step size and momentum scale of fold k - 1
        step_size_rolled = torch.roll(step_size_own, 1)
        scales_rolled = torch.roll(folded_scales, 1, dims=0)

        if low_rank_rank is not None:
            # one metric pooled over every chain; the step size above stays
            # on the per-fold diagonal scale, the damping is whitened by it
            if in_window:
                accum = cgl_update_batch(accum, states.position)
                accum_count += num_chains
            sigma, U, lam = global_lrd(accum, accum_count, states.position, in_window)
            precond_pos = _low_rank_precondition_pos(folded_pos, sigma, U, lam)
            momentum_scale = LowRankInverseMassMatrix(sigma, U, lam)
        else:
            precond_pos = folded_pos / folded_scales[:, None, :]
            momentum_scale = ghmc._per_chain_diagonal(per_chain(scales_rolled))
        centered = precond_pos - _mean(precond_pos, 1)[:, None, :]
        alphas, deltas = _damping(centered, step_size_rolled, t, damping_slowdown)

        new_states, info = ghmc_kernel(
            chain_keys, states, logdensity_fn, per_chain(step_size_rolled), momentum_scale,
            per_chain(alphas), per_chain(deltas))

        if num_folds > 1:
            # the frozen fold does not move this step
            fold = t % num_folds
            skipped = torch.arange(num_chains, device=states.position.device) // n_per_fold == fold

            def restore(new, old):
                mask = skipped.reshape(skipped.shape + (1,) * (new.dim() - 1))
                return torch.where(mask, old, new)

            new_states = tree_map(restore, new_states, states)
            if (t + 1) % num_folds == 0:  # reshuffle the chains across the folds
                perm = prng.permutation(shuffle_key, num_chains)
                new_states = tree_map(lambda x: x[perm], new_states)

        new_adaptation_state = MEADSAdaptationState(
            t + 1, step_size_rolled, scales_rolled, alphas, deltas)
        return new_states, new_adaptation_state, accum, accum_count, info

    def run(rng_key, positions: Array, num_steps: int = 1000):
        nonlocal low_rank_k
        if not torch.is_tensor(positions) or positions.dim() != 2:
            raise ValueError(
                "meads_adaptation takes (num_chains, d) tensor positions: pytree positions "
                "come with ROADMAP queue 1, item 11"
            )
        assert positions.shape[0] == num_chains, (
            "initial `positions` leading dimension must equal the chain count"
        )
        device, dtype = positions.device, positions.dtype
        d = positions.shape[1]
        if isinstance(rng_key, torch.Generator):
            rng_key = prng.from_generator(rng_key, (), device)
        key_init, key_adapt = prng.split(rng_key.to(device)).unbind(0)
        states = ghmc.init(positions, logdensity_fn, prng.split(key_init, num_chains))
        adaptation_state = adapt_init(positions, states.logdensity_grad)

        like = dict(dtype=dtype, device=device)
        if low_rank_rank is not None:
            # rank d is the dense metric; the clamp outlives this call
            low_rank_k = min(low_rank_k, d)
            window_start = int(low_rank_window_fraction * num_steps)
            accum = MomentBlock(torch.zeros((), **like), torch.zeros((d,), **like),
                                torch.zeros((d, d), **like))
        else:
            window_start = num_steps
            accum = None
        accum_count = 0  # the accumulator's count, known on the host

        outputs = []
        for step_idx, key in enumerate(prng.split(key_adapt, num_steps)):
            states, adaptation_state, accum, accum_count, info = one_step(
                key, states, adaptation_state, accum, accum_count, step_idx >= window_start)
            outputs.append(adaptation_info_fn(states, info, adaptation_state))

        if low_rank_rank is not None:
            momentum_inverse_scale = LowRankInverseMassMatrix(
                *global_lrd(accum, accum_count, states.position, True))
        else:
            momentum_inverse_scale = _mean(adaptation_state.position_sigma, 0)
        parameters = {
            "step_size": _mean(adaptation_state.step_size, 0),
            "momentum_inverse_scale": momentum_inverse_scale,
            "alpha": _mean(adaptation_state.alpha, 0),
            "delta": _mean(adaptation_state.delta, 0),
        }

        def stack(*xs):
            if torch.is_tensor(xs[0]):
                return torch.stack(xs)
            return torch.tensor(xs, device=device)  # the host's counters: one copy

        info = tree_map(stack, *outputs) if outputs else None
        return AdaptationResults(states, parameters), info

    return AdaptationAlgorithm(run)
