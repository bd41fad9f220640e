"""MetricCore plugin layer for the staged warmup engine, and the named
recipe registry (reference ``blackjax_tpu/adaptation/metric_recipes.py``).

A ``MetricCore`` is ``(init, update, final)`` over a state that exposes
``.inverse_mass_matrix``:

- ``init(n_dims, *, dtype=None, device=None) -> state``;
- ``update(state, position, grad) -> state``, streaming accumulation of one
  ``(d,)`` draw or an ``(M, d)`` chain block;
- ``final(state) -> state`` at a slow-window boundary: recompute the
  inverse mass matrix and reset the window.

Ported: the ``welford_diag`` and ``welford_dense`` recipes, and the
low-rank ``fisher_low_rank``, ``fisher_low_rank_accumulating``,
``sample_cov_low_rank`` and ``draws_svd_low_rank``. The ``fisher_diag``
recipe of the reference's registry raises ``ValueError`` naming it as not
yet ported.

The low-rank cores keep their draw and gradient buffers on the device and
their counters (``buffer_idx``, ``background_split``, ``recompute_counter``,
the raw-draw ring's row count) as Python integers, so that no step waits
for the device to decide whether to recompute.
"""
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch.adaptation.mass_matrix import mass_matrix_adaptation
from blackjax_tpu_torch.adaptation.metric_buffers import RawDrawRingState, raw_draw_ring_buffer
from blackjax_tpu_torch.adaptation.metric_estimators import (
    _compute_low_rank_metric,
    draws_singular_value_low_rank,
    sample_covariance_eigh_low_rank,
)
from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix
from blackjax_tpu_torch.types import Array

__all__ = [
    "MetricCore",
    "MetricRecipe",
    "LowRankMetricCoreState",
    "REGISTRY",
    "lookup_recipe",
    "seed_low_rank_sigma_from_grad",
]


class MetricCore(NamedTuple):
    init: Callable
    update: Callable
    final: Callable


class LowRankMetricCoreState(NamedTuple):
    """A low-rank core's state: the current payload, the optimal translation
    ``mu*``, circular draw and gradient buffers, and the partial-forget
    bookkeeping (reference ``metric_recipes.py:55``)."""

    inverse_mass_matrix: LowRankInverseMassMatrix
    mu_star: Array
    draws_buffer: Array
    grads_buffer: Array
    buffer_idx: int
    background_split: int
    recompute_counter: int


@dataclasses.dataclass(frozen=True)
class MetricRecipe:
    """A named, parameterized MetricCore constructor. ``needs`` declares the
    per-step inputs the core consumes and is checked against ``provides``
    when the recipe is built."""

    name: str
    build_core: Callable  # (**kwargs) -> MetricCore
    needs: frozenset = frozenset({"positions"})
    provides: frozenset = frozenset({"positions", "gradients"})
    emits: str = "diag"  # "diag" | "dense" | "low_rank"
    provenance: str = ""

    def __post_init__(self):
        if not set(self.needs) <= set(self.provides):
            raise ValueError(
                f"Recipe {self.name!r} declares needs={set(self.needs)} outside "
                f"provides={set(self.provides)}."
            )

    @property
    def provides_dense(self) -> bool:
        return self.emits == "dense"


def _build_welford_core(
    *,
    is_diagonal: bool,
    imm_shrinkage_to_previous: float = 0.0,
    initial_inverse_mass_matrix: Optional[Array] = None,
) -> MetricCore:
    mm_init, mm_update, mm_final = mass_matrix_adaptation(
        is_diagonal_matrix=is_diagonal,
        imm_shrinkage_to_previous=imm_shrinkage_to_previous,
    )

    def init(n_dims: int, *, dtype=None, device=None):
        return mm_init(n_dims, initial_inverse_mass_matrix, dtype=dtype, device=device)

    def update(state, position, grad=None):
        return mm_update(state, position, grad)

    return MetricCore(init, update, mm_final)


def seed_low_rank_sigma_from_grad(
    state: LowRankMetricCoreState, grad: Array
) -> LowRankMetricCoreState:
    """nutpie's gradient-based start: ``sigma_i = 1 / sqrt(|grad_i|)``, so
    the first diagonal is ``1 / |grad_i|``, a diagonal Hessian proxy at the
    starting point, instead of the identity."""
    grad_flat = torch.as_tensor(grad).reshape(-1)
    sigma = 1.0 / torch.sqrt(torch.clamp(grad_flat.abs(), 1e-20, 1e20))
    return state._replace(inverse_mass_matrix=state.inverse_mass_matrix._replace(sigma=sigma))


def _shift_buffer_left(buf: Array, shift: int) -> Array:
    """Drop the first ``shift`` rows and fill the end with zeros."""
    shift = min(max(int(shift), 0), buf.shape[0])
    return torch.cat([buf[shift:], buf.new_zeros((shift, buf.shape[1]))])


def _low_rank_init(n_dims: int, buffer_size: int, max_rank: int, *, dtype=None,
                   device=None) -> LowRankMetricCoreState:
    kw = dict(dtype=dtype, device=device)
    return LowRankMetricCoreState(
        inverse_mass_matrix=LowRankInverseMassMatrix(
            sigma=torch.ones(n_dims, **kw),
            U=torch.zeros((n_dims, max_rank), **kw),
            lam=torch.ones(max_rank, **kw),
        ),
        mu_star=torch.zeros(n_dims, **kw),
        draws_buffer=torch.zeros((buffer_size, n_dims), **kw),
        grads_buffer=torch.zeros((buffer_size, n_dims), **kw),
        buffer_idx=0,
        background_split=0,
        recompute_counter=0,
    )


def _buffer_write(state: LowRankMetricCoreState, position, grad):
    """One ``(d,)`` row or an ``(M, d)`` block into the circular buffers, at
    ``buffer_idx`` modulo the capacity; as the reference's
    ``dynamic_update_slice``, a block that would run past the end is written
    flush with it. Returns new buffers and the new count."""
    pos = torch.atleast_2d(torch.as_tensor(position))
    grad = torch.atleast_2d(torch.as_tensor(grad))
    capacity, rows = state.draws_buffer.shape[0], pos.shape[0]
    start = max(0, min(state.buffer_idx % capacity, capacity - rows))
    draws, grads = state.draws_buffer.clone(), state.grads_buffer.clone()
    draws[start:start + rows] = pos
    grads[start:start + rows] = grad
    return draws, grads, state.buffer_idx + rows


def _kept(state: LowRankMetricCoreState):
    imm = state.inverse_mass_matrix
    return imm.sigma, state.mu_star, imm.U, imm.lam


def _build_fisher_low_rank_core(
    *,
    buffer_size: int,
    max_rank: int = 10,
    gamma: float = 1e-5,
    cutoff: float = 2.0,
) -> MetricCore:
    """The reset policy: accumulate draws and gradients through a window,
    recompute the metric at its end, clear the buffers."""

    def init(n_dims: int, *, dtype=None, device=None) -> LowRankMetricCoreState:
        return _low_rank_init(n_dims, buffer_size, max_rank, dtype=dtype, device=device)

    def update(state: LowRankMetricCoreState, position, grad=None):
        draws, grads, idx = _buffer_write(state, position, grad)
        return state._replace(draws_buffer=draws, grads_buffer=grads, buffer_idx=idx)

    def final(state: LowRankMetricCoreState) -> LowRankMetricCoreState:
        if state.buffer_idx >= 3:
            sigma, mu_star, U, lam = _compute_low_rank_metric(
                state.draws_buffer, state.grads_buffer, state.buffer_idx,
                max_rank, gamma, cutoff,
            )
        else:
            sigma, mu_star, U, lam = _kept(state)
        return LowRankMetricCoreState(
            LowRankInverseMassMatrix(sigma, U, lam),
            mu_star,
            torch.zeros_like(state.draws_buffer),
            torch.zeros_like(state.grads_buffer),
            0, 0, 0,
        )

    return MetricCore(init, update, final)


def _build_fisher_low_rank_accumulating_core(
    *,
    buffer_size: int,
    max_rank: int = 10,
    gamma: float = 1e-5,
    cutoff: float = 2.0,
    recompute_every: int = 1,
) -> MetricCore:
    """nutpie's partial-forget buffer: recompute from the whole buffer every
    ``recompute_every`` updates; at a window's end drop the previous
    window's rows (the background), recompute from the rest, and mark the
    rest as the next background."""

    def init(n_dims: int, *, dtype=None, device=None) -> LowRankMetricCoreState:
        return _low_rank_init(n_dims, buffer_size, max_rank, dtype=dtype, device=device)

    def update(state: LowRankMetricCoreState, position, grad=None):
        draws, grads, idx = _buffer_write(state, position, grad)
        counter = state.recompute_counter + 1
        due = counter % recompute_every == 0 and idx >= 3
        if due:
            sigma, mu_star, U, lam = _compute_low_rank_metric(
                draws, grads, idx, max_rank, gamma, cutoff
            )
        else:
            sigma, mu_star, U, lam = _kept(state)
        return LowRankMetricCoreState(
            LowRankInverseMassMatrix(sigma, U, lam),
            mu_star,
            draws,
            grads,
            idx,
            state.background_split,
            0 if due else counter,
        )

    def final(state: LowRankMetricCoreState) -> LowRankMetricCoreState:
        shift = state.background_split
        draws = _shift_buffer_left(state.draws_buffer, shift)
        grads = _shift_buffer_left(state.grads_buffer, shift)
        n_valid = state.buffer_idx - shift
        if n_valid >= 3:
            sigma, mu_star, U, lam = _compute_low_rank_metric(
                draws, grads, n_valid, max_rank, gamma, cutoff
            )
        else:
            sigma, mu_star, U, lam = _kept(state)
        return LowRankMetricCoreState(
            LowRankInverseMassMatrix(sigma, U, lam), mu_star, draws, grads,
            n_valid, n_valid, 0,
        )

    return MetricCore(init, update, final)


def _build_sample_cov_low_rank_core(*, buffer_size: int, max_rank: int = 10) -> MetricCore:
    """Draws only (MEADS Scheme B): the masked sample covariance of a
    window's draws, eigh, raw top-k."""

    def init(n_dims: int, *, dtype=None, device=None) -> LowRankMetricCoreState:
        return _low_rank_init(n_dims, buffer_size, max_rank, dtype=dtype, device=device)

    def update(state: LowRankMetricCoreState, position, grad=None):
        position = torch.as_tensor(position)
        draws, _, idx = _buffer_write(state, position, torch.zeros_like(position))
        return state._replace(draws_buffer=draws, buffer_idx=idx)

    def final(state: LowRankMetricCoreState) -> LowRankMetricCoreState:
        buf = state.draws_buffer
        B, d = buf.shape
        n = state.buffer_idx
        if n >= 3:
            mask = (torch.arange(B, device=buf.device) < n).to(buf.dtype)
            n_safe = float(max(n, 2))
            mean = (mask[:, None] * buf).sum(0) / n_safe
            centered = mask[:, None] * (buf - mean[None, :])
            payload = sample_covariance_eigh_low_rank(centered.T @ centered, n_safe, max_rank)
            sigma, mu_star, U, lam = payload.sigma, torch.zeros_like(mean), payload.U, payload.lam
        else:
            sigma, mu_star, U, lam = _kept(state)
        return LowRankMetricCoreState(
            LowRankInverseMassMatrix(sigma, U, lam),
            mu_star,
            torch.zeros_like(state.draws_buffer),
            torch.zeros_like(state.grads_buffer),
            0, 0, 0,
        )

    return MetricCore(init, update, final)


class DrawsSVDCoreState(NamedTuple):
    inverse_mass_matrix: LowRankInverseMassMatrix
    ring: RawDrawRingState


def _build_draws_svd_low_rank_core(
    *, capacity: int, max_rank: int = 10, min_support: int = 3
) -> MetricCore:
    """The streaming draws-SVD low-rank core (the MCLMC-LRD pilot estimator)
    over the raw-draw ring: the ring persists across split boundaries,
    forgetting row by row (the last ``capacity`` draws), and every boundary
    recomputes the payload from the masked thin SVD once ``min_support``
    rows are in, else keeps it."""

    def init(n_dims: int, *, dtype=None, device=None) -> DrawsSVDCoreState:
        return DrawsSVDCoreState(
            LowRankInverseMassMatrix(
                sigma=torch.ones(n_dims, dtype=dtype, device=device),
                U=torch.zeros((n_dims, max_rank), dtype=dtype, device=device),
                lam=torch.ones(max_rank, dtype=dtype, device=device),
            ),
            raw_draw_ring_buffer(n_dims, capacity).init(dtype=dtype, device=device),
        )

    def update(state: DrawsSVDCoreState, position, grad=None) -> DrawsSVDCoreState:
        del grad
        ring = raw_draw_ring_buffer(state.ring.draws.shape[1], capacity)
        return state._replace(ring=ring.update(state.ring, torch.atleast_2d(position)))

    def final(state: DrawsSVDCoreState) -> DrawsSVDCoreState:
        n_valid = min(state.ring.count, capacity)
        if n_valid < min_support:
            return state
        mask = torch.arange(capacity, device=state.ring.draws.device) < n_valid
        payload = draws_singular_value_low_rank(state.ring.draws, max_rank, row_mask=mask)
        return DrawsSVDCoreState(payload, state.ring)

    return MetricCore(init, update, final)


REGISTRY: dict[str, MetricRecipe] = {
    "welford_diag": MetricRecipe(
        "welford_diag",
        lambda **kw: _build_welford_core(is_diagonal=True, **kw),
        needs=frozenset({"positions"}),
        emits="diag",
        provenance="Stan-default diagonal Welford covariance (the baseline).",
    ),
    "welford_dense": MetricRecipe(
        "welford_dense",
        lambda **kw: _build_welford_core(is_diagonal=False, **kw),
        needs=frozenset({"positions"}),
        emits="dense",
        provenance="Dense Welford covariance (O(d^2); small d with strong "
        "correlation structure).",
    ),
    "fisher_low_rank": MetricRecipe(
        "fisher_low_rank",
        lambda **kw: _build_fisher_low_rank_core(**kw),
        needs=frozenset({"positions", "gradients"}),
        emits="low_rank",
        provenance="Fisher-divergence low-rank (nutpie Algorithm 1); "
        "max_rank=10, gamma=1e-5, cutoff=2 defaults; computed in float64.",
    ),
    "fisher_low_rank_accumulating": MetricRecipe(
        "fisher_low_rank_accumulating",
        lambda **kw: _build_fisher_low_rank_accumulating_core(**kw),
        needs=frozenset({"positions", "gradients"}),
        emits="low_rank",
        provenance="nutpie partial-forget buffer variant with mid-window "
        "periodic recomputes.",
    ),
    "sample_cov_low_rank": MetricRecipe(
        "sample_cov_low_rank",
        lambda **kw: _build_sample_cov_low_rank_core(**kw),
        needs=frozenset({"positions"}),
        emits="low_rank",
        provenance="Draws-only sample-covariance eigh low-rank (MEADS "
        "Scheme B): raw top-k, no regularization.",
    ),
    "draws_svd_low_rank": MetricRecipe(
        "draws_svd_low_rank",
        lambda **kw: _build_draws_svd_low_rank_core(**kw),
        needs=frozenset({"positions"}),
        emits="low_rank",
        provenance="Streaming raw-draw ring + masked thin-SVD low-rank (the "
        "MCLMC-LRD pilot estimator); persists across splits with "
        "row-granular forgetting.",
    ),
}

# the reference's other recipe (ROADMAP queue 1, item 6)
_NOT_PORTED = ("fisher_diag",)


def lookup_recipe(name: str) -> MetricRecipe:
    if name in _NOT_PORTED:
        raise ValueError(
            f"Metric recipe {name!r} is not yet ported (ROADMAP queue 1, item 6); "
            f"available: {sorted(REGISTRY)}"
        )
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown metric recipe {name!r}; available: {sorted(REGISTRY)}"
        ) from None
