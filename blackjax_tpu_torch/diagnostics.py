"""Convergence diagnostics: R̂, rank-normalized split-R̂ and Stan's effective
sample size (reference ``blackjax_tpu/diagnostics.py``).

Batched tensor arithmetic and one FFT, on the device of the input; no loop
over chains. Also tail ESS, nested R̂ over superchains, Pareto k̂ and
Pareto-smoothed importance weights.
"""
import math

import torch

from blackjax_tpu_torch.types import Array, ArrayLike

__all__ = [
    "potential_scale_reduction",
    "rhat",
    "effective_sample_size",
    "ess",
    "ess_bulk",
    "ess_tail",
    "splitR",
    "pareto_khat",
    "psis_weights",
]


def _to_standard_axes(x: Array, chain_axis: int, sample_axis: int) -> Array:
    """Transpose so chains are axis 0 and samples axis 1 (rest appended)."""
    ndim = x.dim()
    c = chain_axis % ndim
    s = sample_axis % ndim
    rest = [i for i in range(ndim) if i not in (c, s)]
    return x.permute([c, s] + rest)


def _split_chains(x: Array) -> Array:
    """(M, N, ...) -> (2M, N // 2, ...)."""
    m, n = x.shape[0], x.shape[1]
    half = n // 2
    return x[:, : 2 * half].reshape((2 * m, half) + tuple(x.shape[2:]))


def _var(x: Array, dim: int, ddof: int) -> Array:
    return torch.var(x, dim=dim, correction=ddof)


def potential_scale_reduction(
    input_array: ArrayLike, chain_axis: int = 0, sample_axis: int = 1
) -> Array:
    """Gelman-Rubin R̂ on the chains as given (reference ``diagnostics.py:48``)."""
    x = _to_standard_axes(torch.as_tensor(input_array), chain_axis, sample_axis)
    num_samples = x.shape[1]
    within = torch.mean(_var(x, 1, 1), dim=0)
    between = num_samples * _var(torch.mean(x, dim=1), 0, 1)
    var_plus = ((num_samples - 1) / num_samples) * within + between / num_samples
    return torch.sqrt(var_plus / within)


def _rank_normalize(x: Array) -> Array:
    """Rank-normalize pooled draws with the Blom plotting position
    ``z = Phi^-1((r - 3/8) / (S + 1/4))`` (Vehtari et al. 2021); ties are
    ranked in order of appearance, as a stable argsort gives them."""
    shape = x.shape
    total = shape[0] * shape[1]
    flat = x.reshape(total, -1)
    order = torch.argsort(flat, dim=0, stable=True)
    positions = torch.arange(1, total + 1, device=x.device)[:, None].expand_as(order)
    ranks = torch.empty_like(order).scatter_(0, order, positions.contiguous())
    z = torch.special.ndtri((ranks.to(x.dtype) - 0.375) / (total + 0.25))
    return z.reshape(shape)


def rhat(input_array: ArrayLike, chain_axis: int = 0, sample_axis: int = 1) -> Array:
    """Rank-normalized split-R̂ (reference ``diagnostics.py:86``): the max of
    the split-R̂ of the rank-normalized draws and of the folded draws."""
    x = _to_standard_axes(torch.as_tensor(input_array), chain_axis, sample_axis)
    x = _split_chains(x)

    def split_rhat_of(v):
        return potential_scale_reduction(_rank_normalize(v))

    bulk = split_rhat_of(x)
    pooled = x.reshape(x.shape[0] * x.shape[1], -1)
    median = torch.quantile(pooled, 0.5, dim=0).reshape(x.shape[2:])
    folded = split_rhat_of(torch.abs(x - median))
    return torch.maximum(bulk, folded)


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer ``>= n`` (scipy.fftpack.next_fast_len)."""
    best = 1 << max(n - 1, 0).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            p = p35
            while p < n:
                p *= 2
            best = min(best, p)
            p35 *= 3
        p5 *= 5
    return best


def _autocovariance_fft(x: Array) -> Array:
    """Per-chain autocovariance by FFT, biased (divide by N); ``x`` is
    (M, N, ...) centered per chain, lag along axis 1."""
    n = x.shape[1]
    m = _next_fast_len(2 * n)
    f = torch.fft.rfft(x, n=m, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=1)[:, :n]
    return acov / n


def effective_sample_size(
    input_array: ArrayLike, chain_axis: int = 0, sample_axis: int = 1
) -> Array:
    """Stan-compatible effective sample size (reference ``diagnostics.py:119``):
    a cross-chain correlogram from per-chain FFT autocovariances, truncated
    by Geyer's initial positive and monotone sequence."""
    x = _to_standard_axes(torch.as_tensor(input_array), chain_axis, sample_axis)
    m, n = x.shape[0], x.shape[1]
    centered = x - torch.mean(x, dim=1, keepdim=True)
    acov = _autocovariance_fft(centered)

    chain_var = acov[:, 0] * n / (n - 1.0)
    within = torch.mean(chain_var, dim=0)
    if m > 1:
        between = n * _var(torch.mean(x, dim=1), 0, 1)
        var_plus = within * (n - 1.0) / n + between / n
    else:
        var_plus = within * (n - 1.0) / n

    mean_acov = torch.mean(acov, dim=0)
    rho = 1.0 - (within - mean_acov) / var_plus
    rho[0] = 1.0

    # Geyer: pair lags (2t, 2t+1), keep the prefix of positive pair sums,
    # then make it monotone non-increasing
    num_pairs = n // 2
    pair_sums = rho[0 : 2 * num_pairs : 2] + rho[1 : 2 * num_pairs : 2]
    keep = torch.cumprod((pair_sums > 0.0).to(torch.int64), dim=0).to(torch.bool)
    pair_sums = torch.where(keep, pair_sums, torch.zeros_like(pair_sums))
    pair_sums = torch.cummin(pair_sums, dim=0).values
    pair_sums = torch.clamp(pair_sums, min=0.0)
    tau = -1.0 + 2.0 * torch.sum(pair_sums, dim=0)
    mn = torch.tensor(float(m * n), dtype=x.dtype, device=x.device)
    ess_val = m * n / torch.maximum(tau, 1.0 / torch.log10(mn))
    return torch.minimum(ess_val, m * n * torch.log10(mn))


ess = effective_sample_size


def ess_bulk(input_array: ArrayLike, chain_axis: int = 0, sample_axis: int = 1) -> Array:
    """Bulk ESS: Stan ESS of the rank-normalized split chains (reference
    ``diagnostics.py:164``)."""
    x = _to_standard_axes(torch.as_tensor(input_array), chain_axis, sample_axis)
    return effective_sample_size(_rank_normalize(_split_chains(x)))


def _quantile(x: Array, q: float) -> Array:
    """``jnp.quantile(x, q, axis=0)`` with linear interpolation, term by
    term: ``q (n - 1)`` in ``x``'s dtype, the order statistics at its floor
    and ceiling weighted ``1 - w`` and ``w``."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    pos = torch.tensor(q, dtype=x.dtype) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1 - high_weight
    low_value = s[int(min(max(low, 0), n - 1))]
    high_value = s[int(min(max(high, 0), n - 1))]
    return low_value * low_weight.to(x.device) + high_value * high_weight.to(x.device)


def ess_tail(
    input_array: ArrayLike, chain_axis: int = 0, sample_axis: int = 1, prob: float = 0.90
) -> Array:
    """Tail ESS (Vehtari et al. 2021): the smaller of the lower and upper
    tail indicators' ESS over the split chains (reference
    ``diagnostics.py:172``; ``prob=0.90`` gives the 5th and 95th
    percentiles). The indicators are not rank-normalized."""
    x = _split_chains(_to_standard_axes(torch.as_tensor(input_array), chain_axis, sample_axis))
    pooled = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))
    lo = _quantile(pooled, (1.0 - prob) / 2.0)
    hi = _quantile(pooled, (1.0 + prob) / 2.0)
    ess_lower = effective_sample_size((x <= lo).to(x.dtype))
    ess_upper = effective_sample_size((x >= hi).to(x.dtype))
    return torch.minimum(ess_lower, ess_upper)


def splitR(position, num_chains, superchain_size, func_for_splitR=torch.square):
    """Nested R̂ over superchains (Margossian et al. 2023; reference
    ``diagnostics.py:197``): ``position`` is an ensemble ``(num_chains,
    ...)`` whose chains form ``num_chains // superchain_size`` superchains
    that shared a start; R̂ from the between- and within-superchain
    variances of ``func_for_splitR(position)``."""
    fx = func_for_splitR(torch.as_tensor(position))
    fx = fx.reshape(num_chains // superchain_size, superchain_size, -1)
    within = torch.mean(_var(fx, 1, 1), dim=0)
    between = _var(torch.mean(fx, dim=1), 0, 1)
    return torch.sqrt(1.0 + between / within)


def _gpdfit(exceedances: Array) -> tuple[Array, Array]:
    """Empirical-Bayes generalized-Pareto fit (Zhang & Stephens 2009;
    reference ``diagnostics.py:213``) of exceedances sorted ascending:
    ``(k, sigma)``, with the PSIS prior ``k <- (n k + 5) / (n + 10)``."""
    x = exceedances
    n = x.shape[0]
    prior_bs = 3.0
    m_grid = 30 + int(math.sqrt(n))
    j = torch.arange(1, m_grid + 1, dtype=x.dtype, device=x.device)
    q1 = x[max((n + 2) // 4 - 1, 0)]
    q1 = torch.maximum(q1, 1e-30 * torch.clamp(x[-1], min=1e-30))
    bs = 1.0 / x[-1] + (1.0 - torch.sqrt(m_grid / (j - 0.5))) / (prior_bs * q1)
    k_of_b = torch.mean(torch.log1p(-bs[:, None] * x[None, :]), dim=1)
    log_lik = n * (torch.log(-bs / k_of_b) - k_of_b - 1.0)
    w = torch.exp(log_lik - torch.logsumexp(log_lik, dim=0))
    b_hat = torch.sum(bs * w)
    k_hat = torch.mean(torch.log1p(-b_hat * x))
    sigma = -k_hat / b_hat
    k_hat = (n * k_hat + 5.0) / (n + 10.0)
    return k_hat, sigma


def _gpinv(p: Array, k: Array, sigma: Array) -> Array:
    """The generalized-Pareto quantile function (reference
    ``diagnostics.py:251``)."""
    small = torch.abs(k) < 1e-12
    safe_k = torch.where(small, torch.ones_like(k), k)
    x = torch.where(small, -torch.log1p(-p), torch.expm1(-safe_k * torch.log1p(-p)) / safe_k)
    return sigma * x


def pareto_khat(x: ArrayLike, tail: str = "both", tail_frac: float = 0.10) -> Array:
    """Pareto shape k̂ of the draws' tail (reference ``diagnostics.py:263``):
    ``tail`` is ``"left"``, ``"right"`` or ``"both"`` (the larger)."""
    x = torch.as_tensor(x).reshape(-1)
    n = x.shape[0]
    m = max(int(tail_frac * n), 5)

    def khat_right(v):
        s = torch.sort(v).values
        k, _ = _gpdfit(s[n - m:] - s[n - m - 1])
        return k

    if tail == "right":
        return khat_right(x)
    if tail == "left":
        return khat_right(-x)
    return torch.maximum(khat_right(x), khat_right(-x))


def psis_weights(log_ratios: Array, r_eff: float = 1.0) -> tuple[Array, Array]:
    """Pareto-smoothed importance sampling (Vehtari et al. 2024; reference
    ``diagnostics.py:279``): ``(smoothed log weights, k_hat)``. The largest
    ``M = min(0.2 n, 3 sqrt(n / r_eff))`` raw weights become the fitted
    generalized Pareto's expected order statistics, truncated at the raw
    maximum and left unnormalized."""
    log_ratios = torch.as_tensor(log_ratios)
    lw = log_ratios.reshape(-1)
    n = lw.shape[0]
    m = int(min(0.2 * n, 3.0 * (n / r_eff) ** 0.5))
    if m < 5:
        return lw.reshape(log_ratios.shape), torch.tensor(torch.inf, dtype=lw.dtype)
    max_lw = torch.max(lw)
    order = torch.argsort(lw, stable=True)
    sorted_lw = lw[order]
    cutoff = torch.exp(sorted_lw[n - m - 1] - max_lw)
    exceed = torch.exp(sorted_lw[n - m:] - max_lw) - cutoff
    k, sigma = _gpdfit(exceed)
    p = (torch.arange(1, m + 1, dtype=lw.dtype, device=lw.device) - 0.5) / m
    smoothed_tail = torch.minimum(torch.log(cutoff + _gpinv(p, k, sigma)) + max_lw, max_lw)
    new_sorted = torch.cat((sorted_lw[: n - m], smoothed_tail))
    out = torch.empty_like(new_sorted)
    out[order] = new_sorted
    return out.reshape(log_ratios.shape), k
