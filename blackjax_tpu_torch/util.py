"""Shared utilities: linear-map dispatch, noise, the canonical inference loop
(reference ``blackjax_tpu/util.py``).

Positions are flat ``(chains, d)`` tensors (or one ``(d,)`` vector); pytree
positions come with a later slice. State tuples are mapped with
:func:`tree_map`, which walks tuples, NamedTuples, lists and dicts.
"""
from typing import Callable

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey

__all__ = [
    "linear_map",
    "generate_gaussian_noise",
    "generate_unit_vector",
    "pytree_size",
    "run_inference_algorithm",
    "tree_leaves",
    "tree_map",
    "value_and_grad",
]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over matching nested tuples / NamedTuples /
    lists / dicts of tensors; ``None`` and empty tuples pass through."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's flattening order: tuples,
    NamedTuples and lists in order, dicts by sorted key, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def require_tensor_position(position, sampler: str) -> None:
    """Refuse a position that is not a tensor, naming the queue item that
    brings pytree positions."""
    if not torch.is_tensor(position):
        raise ValueError(
            f"{sampler} takes a (C, d) or (d,) tensor position, got {type(position).__name__}: "
            "pytree positions come with ROADMAP queue 1, item 11"
        )


def chain_keys(rng_key: PRNGKey, position: Array) -> Array:
    """Key words on ``position``'s device: ``rng_key`` itself (one key a
    chain, or one key for a single ``(d,)`` position), or, from a
    ``torch.Generator``, one fresh key a chain."""
    if isinstance(rng_key, torch.Generator):
        return prng.from_generator(rng_key, position.shape[:-1], position.device)
    return rng_key.to(position.device)


def value_and_grad(fn: Callable, x: Array) -> tuple[Array, Array]:
    """``(fn(x), d fn / d x)`` by autograd of the batch-summed value.

    ``fn`` maps a ``(..., d)`` batch to ``(...)``; chains are independent,
    so the gradient of the sum is every chain's own gradient."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        value = fn(xg)
        (grad,) = torch.autograd.grad(value.sum(), xg)
    return value.detach(), grad


def linear_map(diag_or_dense_a: Array, b: Array) -> Array:
    """``A b`` over the last axis of ``b`` (reference ``util.py:38``).

    A scalar or 1-d ``A`` is a diagonal and multiplies elementwise; a 2-d
    ``A`` is dense and applies to every row of a ``(..., d)`` batch."""
    if not torch.is_tensor(diag_or_dense_a):  # a number: a weak scalar, in b's dtype
        return diag_or_dense_a * b
    a = diag_or_dense_a.to(b.device)
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if a.dim() <= 1:
        return a * b
    return b @ a.T


def _standard_normal(rng_key: PRNGKey, position: Array) -> Array:
    """Standard normals shaped like ``position``: from a generator, or from
    key words ``(..., 2)``, each key drawing ``jax.random.normal`` over the
    trailing axes of ``position`` that its batch axes leave (a ``(C, 2)``
    key batch and a ``(C, d)`` position: a ``(d,)`` draw per chain)."""
    if isinstance(rng_key, torch.Generator):
        return torch.randn(
            position.shape, generator=rng_key, dtype=position.dtype, device=position.device
        )
    keys = rng_key.to(position.device)
    return prng.normal(keys, position.shape[keys.dim() - 1:], position.dtype)


def generate_gaussian_noise(
    rng_key: PRNGKey,
    position: Array,
    mu: float | Array = 0.0,
    sigma: float | Array = 1.0,
) -> Array:
    """``mu + sigma eps`` with ``eps ~ N(0, I)`` shaped like ``position``
    (reference ``util.py:54``); ``sigma`` is a scalar, a diagonal or a dense
    scale applied through :func:`linear_map`. ``rng_key`` is a generator or
    key words (see :func:`_standard_normal`)."""
    return mu + linear_map(sigma, _standard_normal(rng_key, position))


def generate_unit_vector(rng_key: PRNGKey, position: Array) -> Array:
    """A uniform random unit vector per chain, shaped like ``position``
    (reference ``util.py:68``): a ``(C, d)`` position gets ``C`` unit rows,
    normalised over the last axis."""
    eps = _standard_normal(rng_key, position)
    return eps / torch.linalg.vector_norm(eps, dim=-1, keepdim=True)


def pytree_size(pytree: ArrayLikeTree) -> int:
    """Total number of elements (reference ``util.py:76``)."""
    total = []
    tree_map(lambda leaf: total.append(torch.as_tensor(leaf).numel()), pytree)
    return sum(total)


def run_inference_algorithm(
    rng_key: PRNGKey,
    inference_algorithm: SamplingAlgorithm,
    num_steps: int,
    initial_state: ArrayLikeTree = None,
    initial_position: ArrayLikeTree = None,
    transform: Callable = lambda state, info: (state, info),
) -> tuple:
    """The canonical inference loop (reference ``util.py:88``): ``num_steps``
    kernel applications, each drawing from ``rng_key``.

    Returns ``(final_state, history)``, where ``history`` is
    ``transform(state, info)`` stacked over steps along a new leading axis,
    as the reference's ``lax.scan`` stacks it.
    """
    if initial_state is None and initial_position is None:
        raise ValueError("Either `initial_state` or `initial_position` must be provided.")
    if initial_state is not None and initial_position is not None:
        raise ValueError("Only one of `initial_state` or `initial_position` must be provided.")
    state = initial_state
    if state is None:
        state = inference_algorithm.init(initial_position, rng_key)
    outputs = []
    for _ in range(num_steps):
        state, info = inference_algorithm.step(rng_key, state)
        outputs.append(transform(state, info))
    if not outputs:
        return state, None
    history = tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *outputs)
    return state, history
