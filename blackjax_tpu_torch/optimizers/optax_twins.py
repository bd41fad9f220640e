"""The optax pieces the port's warmups use, in PyTorch (optax imports JAX,
which the port may not).

``adam`` is optax 0.2.6's ``adam``: ``chain(scale_by_adam(b1, b2, eps,
eps_root), scale(-learning_rate))``, with the state ``(ScaleByAdamState(count,
mu, nu), EmptyState())`` and the order of operations of ``scale_by_adam``:
the moments ``(1 - b) g**k + b m`` (one fused multiply-add, as XLA contracts
them in a compiled loop of updates), the int32 ``count`` incremented, the bias
corrections ``c = 1 - b**count`` and ``mu / (c1 (sqrt(nu / c2 + eps_root) +
eps))`` (XLA's simplifier folds the two divisions of ``mu_hat / (...)``
into one), then the scale. So optax's updates compiled in a ``scan`` and
these agree bit for bit. Parameters and updates are tensors or tuples of
tensors. ``apply_updates`` adds the updates in the parameters' dtypes.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.prng import exact_sqrt

__all__ = [
    "GradientTransformation",
    "ScaleByAdamState",
    "EmptyState",
    "adam",
    "apply_updates",
]

_INT32_MAX = 2**31 - 1


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(updates, state, params=None)
    -> (updates, state)``."""

    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: object
    nu: object


class EmptyState(NamedTuple):
    """The stateless ``scale``'s state."""


def _map(fn, *trees):
    """``fn`` over the leaves of tensors or (nested) tuples of tensors."""
    first = trees[0]
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _moment(g, m, decay, order):
    """``(1 - decay) g**order + decay m`` with one product fused into the
    sum, as XLA's CPU backend contracts it in a compiled loop of updates (a
    ``scan``, as the warmups run): ``(1 - decay) g**order`` in float32,
    ``decay m`` in float64."""
    power = g if order == 1 else g * g
    if m.dtype == torch.float32:
        return torch.addcmul(decay * m, torch.full_like(power, 1 - decay), power)
    return torch.addcmul((1 - decay) * power, torch.full_like(m, decay), m)


def _bias_correction(decay, count, like):
    """``1 - decay**count``, the power in the moment's dtype, as XLA raises a
    float to an int32 array (float32 without x64, float64 with it)."""
    base = torch.tensor(decay, dtype=like.dtype, device=like.device)
    return 1 - torch.pow(base, count.to(like.dtype))


def adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    eps_root: float = 0.0,
) -> GradientTransformation:
    """optax's ``adam(learning_rate, b1, b2, eps, eps_root)`` (a constant
    learning rate)."""

    def init(params):
        zeros = _map(torch.zeros_like, params)
        count = torch.zeros((), dtype=torch.int32, device=_device(params))
        return ScaleByAdamState(count, zeros, _map(torch.zeros_like, params)), EmptyState()

    def update(updates, state, params=None):
        del params
        adam_state, empty = state
        mu = _map(lambda g, m: _moment(g, m, b1, 1), updates, adam_state.mu)
        nu = _map(lambda g, v: _moment(g, v, b2, 2), updates, adam_state.nu)
        count = torch.where(adam_state.count < _INT32_MAX, adam_state.count + 1,
                            adam_state.count)

        def step(m, v):
            nu_hat = v / _bias_correction(b2, count, v)
            denominator = exact_sqrt(nu_hat + eps_root) + eps
            # XLA rewrites (m / c1) / d as m / (c1 * d)
            return -learning_rate * (m / (_bias_correction(b1, count, m) * denominator))

        return _map(step, mu, nu), (ScaleByAdamState(count, mu, nu), empty)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``params + updates``, each sum in its parameter's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _device(params):
    leaf = params
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    return leaf.device
