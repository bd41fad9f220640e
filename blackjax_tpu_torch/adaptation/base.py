"""Adaptation result containers and info filters (reference
``blackjax_tpu/adaptation/base.py``). The containers themselves are the
port's :mod:`blackjax_tpu_torch.base` ones."""
from typing import Set

from blackjax_tpu_torch.base import AdaptationInfo, AdaptationResults

__all__ = [
    "AdaptationResults",
    "AdaptationInfo",
    "return_all_adapt_info",
    "get_filter_adapt_info_fn",
]


def return_all_adapt_info(state, info, adaptation_state) -> AdaptationInfo:
    """Keep everything: O(num_steps * state size) memory."""
    return AdaptationInfo(state, info, adaptation_state)


def get_filter_adapt_info_fn(
    state_keys: Set[str] = frozenset(),
    info_keys: Set[str] = frozenset(),
    adapt_state_keys: Set[str] = frozenset(),
):
    """An info filter that keeps only the named fields of each NamedTuple
    and sets the others to ``None`` (memory control for long warmups)."""

    def _select(named_tuple, keys):
        return type(named_tuple)(
            **{
                field: (getattr(named_tuple, field) if field in keys else None)
                for field in named_tuple._fields
            }
        )

    def filter_fn(state, info, adaptation_state) -> AdaptationInfo:
        return AdaptationInfo(
            _select(state, state_keys),
            _select(info, info_keys),
            _select(adaptation_state, adapt_state_keys),
        )

    return filter_fn
