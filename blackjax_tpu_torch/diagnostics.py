"""Convergence diagnostics: R̂, rank-normalized split-R̂ and Stan's effective
sample size (reference ``blackjax_tpu/diagnostics.py``).

Batched tensor arithmetic and one FFT, on the device of the input; no loop
over chains. Nested R̂, Pareto k̂ and PSIS come with a later slice.
"""
import torch

from blackjax_tpu_torch.types import Array, ArrayLike

__all__ = [
    "potential_scale_reduction",
    "rhat",
    "effective_sample_size",
    "ess",
    "ess_bulk",
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
