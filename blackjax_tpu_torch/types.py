"""Type aliases shared across the port (reference ``blackjax_tpu/types.py``).

Positions are flat ``(chains, d)`` tensors in this slice. Randomness comes
from a ``torch.Generator``, or from key words: an int64 tensor ``(..., 2)``
holding ``jax.random.key_data`` of the reference's keys, one key per chain
(:mod:`blackjax_tpu_torch.prng`), with which the port draws what the
reference draws.
"""
from typing import Any, Union

import torch

__all__ = ["Array", "ArrayLike", "ArrayTree", "ArrayLikeTree", "PRNGKey", "Numeric"]

Array = torch.Tensor
ArrayLike = Union[torch.Tensor, Any]

# nested tuples / NamedTuples of tensors; aliases for documentation
ArrayTree = Any
ArrayLikeTree = Any

PRNGKey = Union[torch.Generator, torch.Tensor]
Numeric = Union[torch.Tensor, float, int]
