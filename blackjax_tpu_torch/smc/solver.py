"""Bisection root solver for the adaptive-tempering ESS equation (reference
``blackjax_tpu/smc/solver.py``).

The reference's ``lax.while_loop`` inside two ``lax.cond``s is a loop on
the host here: each bisection evaluates ``fun`` on the device and reads
the loop's condition ``(i < max_iter) & (f_a - f_b > eps)``, and the
branch conditions, to the host. The arithmetic is the reference's, so the
root is the same, bit for bit, wherever ``fun`` is.
"""
import math
from typing import Callable, Union

import torch

from blackjax_tpu_torch.types import Array

__all__ = ["dichotomy"]


def dichotomy(
    fun: Callable,
    min_delta: Union[float, Array],
    max_delta: Union[float, Array],
    eps: float = 1e-4,
    max_iter: int = 100,
) -> Array:
    """Root of a decreasing ``fun`` on ``[min_delta, max_delta]`` by
    bisection. If ``fun(max_delta) > 0`` the whole interval is feasible and
    ``max_delta`` is returned; if ``fun(min_delta) <= 0`` there is no root
    and NaN is returned."""
    # the bounds as tensors in max_delta's dtype and on its device (the
    # reference's `+ 0.0` promotes a number so)
    like = max_delta if torch.is_tensor(max_delta) else torch.tensor(
        0.0, dtype=torch.get_default_dtype())
    lo, hi = (torch.as_tensor(bound, dtype=like.dtype, device=like.device)
              for bound in (min_delta, max_delta))
    f_min, f_max = fun(lo), fun(hi)
    if bool(f_max > 0):
        return hi + 0.0
    if not bool(f_min > 0):
        return torch.full_like(torch.as_tensor(f_min), math.nan)
    i, a, b, f_a, f_b = 0, lo, hi, f_min, f_max
    while i < max_iter and bool(f_a - f_b > eps):
        mid = 0.5 * (a + b)
        f_mid = fun(mid)
        go_left = f_mid < 0
        a = torch.where(go_left, a, mid)
        f_a = torch.where(go_left, f_a, f_mid)
        b = torch.where(go_left, mid, b)
        f_b = torch.where(go_left, f_mid, f_b)
        i += 1
    return a
