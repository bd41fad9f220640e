"""Type aliases shared across the port (reference ``blackjax_tpu/types.py``).

Positions are flat ``(chains, d)`` tensors in this slice; randomness comes
from a ``torch.Generator`` where the reference takes a JAX PRNG key.
"""
from typing import Any, Union

import torch

__all__ = ["Array", "ArrayLike", "ArrayTree", "ArrayLikeTree", "PRNGKey", "Numeric"]

Array = torch.Tensor
ArrayLike = Union[torch.Tensor, Any]

# nested tuples / NamedTuples of tensors; aliases for documentation
ArrayTree = Any
ArrayLikeTree = Any

PRNGKey = torch.Generator
Numeric = Union[torch.Tensor, float, int]
