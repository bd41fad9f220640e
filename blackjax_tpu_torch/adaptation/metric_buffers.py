"""The buffer layer of metric adaptation: mergeable moment blocks in place of
raw draw rings (reference ``blackjax_tpu/adaptation/metric_buffers.py``).

A block holds the sufficient statistics ``(count, mean, M2)`` of a set of
draws, ``(d,)`` or ``(d, d)``; merging blocks (Chan, Golub & LeVeque 1983)
rebuilds the window's estimate, and dropping the oldest block forgets one
split exactly. Every policy is the :class:`MetricBuffer` bundle over a state
of tensors on the draws' device. What does not depend on the draws, a
ring's write position, a raw ring's lifetime row count and ``late_start``'s
skip count, is a Python integer, so no update waits for the device to decide
where to write. An ensemble ``(n_chains, d)`` batch folds every chain into
the active block: a split partitions time, never the chains. Pooling over a
device mesh (``axis_name``) comes with ROADMAP queue 1, item 12.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch.adaptation.chees_adaptation import _MESH
from blackjax_tpu_torch.types import Array

__all__ = [
    "MetricBuffer",
    "MomentBlock",
    "RawDrawRingState",
    "cgl_merge_two",
    "cgl_update_batch",
    "merge_block_ring",
    "diag_from_moment_block",
    "raw_draw_ring_buffer",
    "reset_window_buffer",
    "accumulating_split_pop_buffer",
    "ensemble_batch_buffer",
    "late_start",
]


class MetricBuffer(NamedTuple):
    """A buffer policy: ``init(*, dtype=None, device=None)``,
    ``update(state, batch)``, ``push_split`` (close the active accumulation),
    ``get_moments`` (the merged block), ``get_support`` and
    ``get_diag_reference`` (the Bessel variance a step-size proxy reads)."""

    init: Callable
    update: Callable
    push_split: Callable
    get_moments: Callable
    get_support: Callable
    get_diag_reference: Callable


class MomentBlock(NamedTuple):
    """Chan-Golub-LeVeque sufficient statistics: ``count`` a 0-d tensor,
    ``m2`` the SUM of squared deviations (dense ``(d, d)`` or diagonal
    ``(d,)``), not the covariance."""

    count: Array
    mean: Array
    m2: Array


def cgl_merge_two(block_a: MomentBlock, block_b: MomentBlock) -> MomentBlock:
    """The exact parallel merge of two blocks; an empty block (count 0) is
    absorbed, and two empty blocks merge to zeros."""
    n_a, n_b = block_a.count, block_b.count
    n_ab = n_a + n_b
    nonempty = n_ab > 0
    delta = block_b.mean - block_a.mean
    safe_n = torch.where(nonempty, n_ab, torch.ones_like(n_ab))

    mean_ab = block_a.mean + delta * (n_b / safe_n)
    if block_a.m2.dim() == 1:
        cross = delta * delta * (n_a * n_b / safe_n)
    else:
        cross = torch.outer(delta, delta) * (n_a * n_b / safe_n)
    m2_ab = block_a.m2 + block_b.m2 + cross

    mean_ab = torch.where(nonempty, mean_ab, torch.zeros_like(mean_ab))
    m2_ab = torch.where(nonempty, m2_ab, torch.zeros_like(m2_ab))
    return MomentBlock(n_ab, mean_ab, m2_ab)


def cgl_update_batch(block: MomentBlock, batch: Array,
                     axis_name: Optional[str] = None) -> MomentBlock:
    """Fold a raw ``(n_b, d)`` batch into a block, its statistics computed
    inline."""
    if axis_name is not None:
        raise NotImplementedError(_MESH)
    n_b = torch.full_like(block.count, batch.shape[0])
    mean_b = batch.sum(0) / batch.shape[0]
    centered = batch - mean_b[None, :]
    if block.m2.dim() == 1:
        m2_b = (centered**2).sum(0)
    else:
        m2_b = centered.T @ centered
    return cgl_merge_two(block, MomentBlock(n_b, mean_b, m2_b))


def merge_block_ring(counts: Array, means: Array, m2s: Array) -> MomentBlock:
    """Reduce a ring of ``k`` blocks into one, oldest slot first from an
    empty block; ``k = 1`` is the slot itself."""
    k = counts.shape[0]
    if k == 1:
        return MomentBlock(counts[0], means[0], m2s[0])
    merged = MomentBlock(torch.zeros_like(counts[0]), torch.zeros_like(means[0]),
                         torch.zeros_like(m2s[0]))
    for i in range(k):
        merged = cgl_merge_two(merged, MomentBlock(counts[i], means[i], m2s[i]))
    return merged


def diag_from_moment_block(block: MomentBlock) -> Array:
    """The Bessel-corrected variance per coordinate; ones where the count is
    below 2 (the isotropic fallback a step-size proxy needs in place of 0 or
    NaN)."""
    denom = torch.clamp(block.count - 1.0, min=1.0)
    var = (torch.diagonal(block.m2) if block.m2.dim() == 2 else block.m2) / denom
    return torch.where(block.count >= 2, var, torch.ones_like(var))


def _set_row(x: Array, i: int, value) -> Array:
    """``x.at[i].set(value)``: a copy of ``x`` with row ``i`` replaced."""
    out = x.clone()
    out[i] = value
    return out


class AccumulatingSplitPopState(NamedTuple):
    """A ring of ``k`` blocks: the active one at ``write_pos`` and up to
    ``k - 1`` completed ones; wrapping forgets the oldest split."""

    counts: Array  # (k,)
    means: Array  # (k, d)
    m2s: Array  # (k, d, d) or (k, d)
    write_pos: int


class LateStartState(NamedTuple):
    inner: NamedTuple
    num_skipped: int


class RawDrawRingState(NamedTuple):
    """A circular window of raw draws: the last ``capacity`` rows, masked
    while it fills. ``count`` is the lifetime number of rows written (the
    support), ``write_pos`` the next slot."""

    draws: Array  # (capacity, d)
    count: int
    write_pos: int


def raw_draw_ring_buffer(d: int, capacity: int) -> MetricBuffer:
    """The raw-draw ring of the estimators that need draws (the draws-SVD
    low-rank pilot, :func:`~blackjax_tpu_torch.adaptation.metric_estimators.
    draws_singular_value_low_rank`). Forgetting is row by row (a fixed
    window of ``capacity`` rows), so ``push_split`` changes nothing.

    ``get_moments`` masks the unfilled slots, so its block is exact over the
    valid rows; the draws themselves are the state's, for the SVD (masked
    rows add nothing to ``X^T X``)."""
    if capacity < 2:
        raise ValueError(f"capacity must be >= 2, got {capacity}")

    def init(*, dtype=None, device=None) -> RawDrawRingState:
        return RawDrawRingState(torch.zeros((capacity, d), dtype=dtype, device=device), 0, 0)

    def update(state: RawDrawRingState, batch: Array) -> RawDrawRingState:
        if batch.dim() == 1:
            batch = batch[None, :]
        rows = batch.shape[0]
        if rows > capacity:
            raise ValueError(f"batch of {rows} rows exceeds ring capacity {capacity}")
        # each row wraps on its own: at most two slices
        draws = state.draws.clone()
        head = min(rows, capacity - state.write_pos)
        draws[state.write_pos:state.write_pos + head] = batch[:head]
        draws[:rows - head] = batch[head:]
        return RawDrawRingState(draws, state.count + rows, (state.write_pos + rows) % capacity)

    def push_split(state: RawDrawRingState) -> RawDrawRingState:
        return state  # a row-granular window: split boundaries forget nothing

    def n_valid(state: RawDrawRingState) -> int:
        return min(state.count, capacity)

    def valid_mask(state: RawDrawRingState) -> Array:
        return torch.arange(capacity, device=state.draws.device) < n_valid(state)

    def get_moments(state: RawDrawRingState) -> MomentBlock:
        mask = valid_mask(state)[:, None]
        draws = state.draws
        mean = torch.where(mask, draws, torch.zeros_like(draws)).sum(0) / max(n_valid(state), 1)
        centered = torch.where(mask, draws - mean[None, :], torch.zeros_like(draws))
        return MomentBlock(draws.new_full((), n_valid(state)), mean, centered.T @ centered)

    def get_support(state: RawDrawRingState):
        return n_valid(state), valid_mask(state).to(state.draws.dtype)

    def get_diag_reference(state: RawDrawRingState) -> Array:
        return diag_from_moment_block(get_moments(state))

    return MetricBuffer(init, update, push_split, get_moments, get_support, get_diag_reference)


def _make_ring_buffer(
    d: int,
    k: int,
    diagonal: bool,
    n_chains_per_update: Optional[int],
    requires_draws: bool,
) -> MetricBuffer:
    if requires_draws:
        # raw rows in place of blocks; k scales the row capacity (k splits of
        # about d / 2 rows)
        return raw_draw_ring_buffer(d, max(2, k * max(d // 2, 2)))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    m2_shape = (d,) if diagonal else (d, d)

    def init(*, dtype=None, device=None) -> AccumulatingSplitPopState:
        return AccumulatingSplitPopState(
            counts=torch.zeros((k,), dtype=dtype, device=device),
            means=torch.zeros((k, d), dtype=dtype, device=device),
            m2s=torch.zeros((k,) + m2_shape, dtype=dtype, device=device),
            write_pos=0,
        )

    def update(state: AccumulatingSplitPopState, batch: Array) -> AccumulatingSplitPopState:
        if batch.dim() == 1:
            batch = batch[None, :]
        if n_chains_per_update is not None and batch.shape[0] != n_chains_per_update:
            raise ValueError(
                f"ensemble_batch_buffer expects batch.shape[0]={n_chains_per_update}, got "
                f"{batch.shape[0]}; partial batches are not supported."
            )
        wp = state.write_pos
        updated = cgl_update_batch(
            MomentBlock(state.counts[wp], state.means[wp], state.m2s[wp]), batch
        )
        return AccumulatingSplitPopState(
            _set_row(state.counts, wp, updated.count),
            _set_row(state.means, wp, updated.mean),
            _set_row(state.m2s, wp, updated.m2),
            wp,
        )

    def push_split(state: AccumulatingSplitPopState) -> AccumulatingSplitPopState:
        """Advance to a fresh slot, emptying the oldest on a wrap (for
        ``k = 1``, Stan's hard reset). Read the moments BEFORE pushing."""
        new_wp = (state.write_pos + 1) % k
        return AccumulatingSplitPopState(
            _set_row(state.counts, new_wp, 0.0),
            _set_row(state.means, new_wp, 0.0),
            _set_row(state.m2s, new_wp, 0.0),
            new_wp,
        )

    def get_moments(state: AccumulatingSplitPopState) -> MomentBlock:
        return merge_block_ring(state.counts, state.means, state.m2s)

    def get_support(state: AccumulatingSplitPopState):
        return state.counts.sum(), state.counts

    def get_diag_reference(state: AccumulatingSplitPopState) -> Array:
        return diag_from_moment_block(get_moments(state))

    return MetricBuffer(init, update, push_split, get_moments, get_support, get_diag_reference)


def reset_window_buffer(d: int, *, diagonal: bool = False,
                        requires_draws: bool = False) -> MetricBuffer:
    """Stan's semantics: one block, emptied at every split boundary."""
    return _make_ring_buffer(d, 1, diagonal, None, requires_draws)


def accumulating_split_pop_buffer(d: int, k: int, *, diagonal: bool = False,
                                  requires_draws: bool = False) -> MetricBuffer:
    """A rolling window of the last ``k`` splits, the oldest forgotten whole
    on a wrap."""
    return _make_ring_buffer(d, k, diagonal, None, requires_draws)


def ensemble_batch_buffer(d: int, n_chains: int, k: int = 1, *, diagonal: bool = False,
                          requires_draws: bool = False) -> MetricBuffer:
    """The ensemble feed: every update folds a full ``(n_chains, d)``
    snapshot into the active block (another row count raises); splits
    partition time, never chains."""
    return _make_ring_buffer(d, k, diagonal, n_chains, requires_draws)


def late_start(inner_buffer: MetricBuffer, offset_steps: int) -> MetricBuffer:
    """Skip the first ``offset_steps`` updates of each split (the draws still
    in transit right after a window boundary)."""

    def init(*args, **kwargs) -> LateStartState:
        return LateStartState(inner_buffer.init(*args, **kwargs), 0)

    def update(state: LateStartState, batch: Array) -> LateStartState:
        inner = state.inner
        if state.num_skipped >= offset_steps:
            inner = inner_buffer.update(inner, batch)
        return LateStartState(inner, min(state.num_skipped + 1, offset_steps))

    def push_split(state: LateStartState) -> LateStartState:
        return LateStartState(inner_buffer.push_split(state.inner), 0)

    def get_moments(state: LateStartState):
        return inner_buffer.get_moments(state.inner)

    def get_support(state: LateStartState):
        return inner_buffer.get_support(state.inner)

    def get_diag_reference(state: LateStartState):
        return inner_buffer.get_diag_reference(state.inner)

    return MetricBuffer(init, update, push_split, get_moments, get_support, get_diag_reference)
