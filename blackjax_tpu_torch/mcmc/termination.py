"""Iterative U-turn termination for NUTS, checkpointing scheme (reference
``blackjax_tpu/mcmc/termination.py``).

Leaves are indexed 0.. within the current subtree. Even leaf ``n`` stores
``(m_n, S_n)`` at slot ``popcount(n >> 1)``; odd leaf ``n`` checks the
subtrees of sizes 2, 4, ... that end at ``n``: slots ``idx_min .. idx_max``
with ``idx_max = popcount(n >> 1)`` and ``idx_min = idx_max -
trailing_ones(n) + 1``. Checkpoints carry a leading chain axis
``(..., max_depth, d)``.
"""
from typing import NamedTuple

import torch

from blackjax_tpu_torch.ops.counter_rng import popcount8
from blackjax_tpu_torch.types import Array

__all__ = ["IterativeUTurnState", "iterative_uturn", "iterative_uturn_numpyro"]


class IterativeUTurnState(NamedTuple):
    momentum_ckpts: Array  # (..., max_depth, d)
    momentum_sum_ckpts: Array  # (..., max_depth, d)
    idx_min: Array
    idx_max: Array


def _checkpoint_slots(leaf_idx: Array):
    """``(idx_min, idx_max)`` checkpoint slot range of a leaf index."""
    leaf_idx = torch.as_tensor(leaf_idx, dtype=torch.int64)
    idx_max = popcount8(leaf_idx >> 1)
    trailing_ones = popcount8(((~leaf_idx) & (leaf_idx + 1)) - 1)
    return idx_max - trailing_ones + 1, idx_max


def _slot_turning(is_turning, ckpt_r, ckpt_s, momentum_sum, momentum, idx_min, idx_max):
    """Whether any subtree ending at the current leaf turns: every slot
    ``i`` in ``idx_min .. idx_max`` tests the subtree of momentum sum
    ``momentum_sum - ckpt_s[i] + ckpt_r[i]`` between ``ckpt_r[i]`` and
    ``momentum``. All slots go through ``is_turning`` at once over a slot axis
    ``(..., K, d)``: per element the arithmetic of the reference's per-slot
    loop, and one call in place of K (both NUTS engines use this, so they
    round alike)."""
    row = torch.arange(ckpt_r.shape[-2], device=momentum.device)
    active = (row >= idx_min[..., None]) & (row <= idx_max[..., None])
    subtree_sum = momentum_sum[..., None, :] - ckpt_s + ckpt_r
    return (active & is_turning(ckpt_r, momentum[..., None, :], subtree_sum)).any(-1)


def iterative_uturn(is_turning):
    """``(new_state, update, is_criterion_met)`` of the checkpointing U-turn
    criterion for a metric's ``is_turning``."""

    def new_state(chain_state, max_num_doublings) -> IterativeUTurnState:
        position = chain_state.position
        batch, d = position.shape[:-1], position.shape[-1]
        zeros = position.new_zeros(batch + (max_num_doublings, d))
        izero = torch.zeros(batch, dtype=torch.int64, device=position.device)
        return IterativeUTurnState(zeros, zeros, izero, izero)

    def update(state: IterativeUTurnState, momentum_sum, momentum, leaf_idx):
        leaf_idx = torch.as_tensor(leaf_idx, dtype=torch.int64, device=momentum.device)
        idx_min, idx_max = _checkpoint_slots(leaf_idx)
        is_even = (leaf_idx % 2) == 0
        row = torch.arange(state.momentum_ckpts.shape[-2], device=momentum.device)
        write = (is_even[..., None] & (row == idx_max[..., None]))[..., None]
        momentum_ckpts = torch.where(write, momentum[..., None, :], state.momentum_ckpts)
        momentum_sum_ckpts = torch.where(
            write, momentum_sum[..., None, :], state.momentum_sum_ckpts
        )
        return IterativeUTurnState(momentum_ckpts, momentum_sum_ckpts, idx_min, idx_max)

    def is_criterion_met(state: IterativeUTurnState, momentum_sum, momentum):
        ckpt_r, ckpt_s, idx_min, idx_max = state
        return _slot_turning(is_turning, ckpt_r, ckpt_s, momentum_sum, momentum, idx_min,
                             idx_max)

    return new_state, update, is_criterion_met


# the reference's public alias (``termination.py:31``)
iterative_uturn_numpyro = iterative_uturn
