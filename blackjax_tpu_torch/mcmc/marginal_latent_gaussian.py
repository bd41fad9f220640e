"""The marginal auxiliary-gradient sampler for latent Gaussian models
(Titsias & Papaspiliopoulos 2018; reference
``blackjax_tpu/mcmc/marginal_latent_gaussian.py``), with the prior
covariance diagonalized once so that a step is a few matrix products in
its eigenbasis.

One transition moves every chain of a ``(C, d)`` block; its randomness is
a key per chain, split into the proposal key and the accept key as the
reference splits it (a ``torch.Generator`` draws one key a chain first).
:func:`svd_from_covariance` takes the eigenvectors from
``torch.linalg.eigh``, whose signs may differ from ``jnp.linalg.svd``'s:
``U Gamma U^T`` is the same matrix, but the draws depend on ``U``, so a
kernel held against the reference takes the reference's own
:class:`CovarianceSVD` (``cov_svd=``).
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc.proposal import static_binomial_sampling
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, require_tensor_position, value_and_grad

__all__ = [
    "MarginalState",
    "MarginalInfo",
    "CovarianceSVD",
    "svd_from_covariance",
    "init",
    "build_kernel",
    "as_top_level_api",
]


class MarginalState(NamedTuple):
    """Chain state with its position and gradient in the prior covariance's
    eigenbasis."""

    position: ArrayLikeTree
    logdensity: Array
    logdensity_grad: ArrayLikeTree
    U_x: Array
    U_grad_x: Array


class CovarianceSVD(NamedTuple):
    U: Array
    Gamma: Array
    U_t: Array


class MarginalInfo(NamedTuple):
    acceptance_rate: Array
    is_accepted: Array
    proposal: MarginalState


def svd_from_covariance(covariance: Array) -> CovarianceSVD:
    """The SVD of a symmetric covariance by its eigendecomposition, as
    ``jnp.linalg.svd(..., hermitian=True)`` computes it: singular values
    ``|w|`` in descending order, ``U`` the matching eigenvectors, ``U_t =
    (U sign(w))^T``."""
    covariance = torch.as_tensor(covariance)
    w, v = torch.linalg.eigh(covariance)
    order = torch.argsort(torch.abs(w), descending=True)
    w, U = w[order], v[:, order]
    return CovarianceSVD(U, torch.abs(w), (U * torch.sign(w)).T)


def generate_mean_shifted_logprob(logdensity_fn, mean, covariance):
    """Fold a nonzero prior mean into the likelihood as the linear term
    ``x . C^-1 m``, so that the kernel can take the prior as centred."""
    covariance = torch.as_tensor(covariance)
    mean = torch.as_tensor(mean, dtype=covariance.dtype, device=covariance.device).reshape(-1)
    shift = torch.cholesky_solve(mean[:, None], torch.linalg.cholesky(covariance))[:, 0]

    def shifted(x):
        return logdensity_fn(x) + x @ shift.to(x)

    return shifted


def _spectral_view(logdensity_fn, U_t, position):
    """The log density and gradient, both projected into the eigenbasis."""
    logdensity, grad = value_and_grad(logdensity_fn, position)
    U_t = U_t.to(position)
    return MarginalState(position, logdensity, grad, position @ U_t.T, grad @ U_t.T)


def init(position, logdensity_fn, U_t):
    require_tensor_position(position, "mgrad_gaussian")
    return _spectral_view(logdensity_fn, U_t, position)


def _proposal_gains(Gamma, delta):
    """The coefficients per eigenvalue of the proposal, with ``a =
    delta / 2``: ``gain = a g / (a + g)`` and ``mix = (a + g) / (a + 2 g)``;
    the proposal's noise variance is ``gain / mix``."""
    a = 0.5 * delta
    gain = a * Gamma / (a + Gamma)
    mix = (a + Gamma) / (a + 2.0 * Gamma)
    return a, gain, mix


def build_kernel(cov_svd: CovarianceSVD):
    """The mGrad kernel; ``delta`` is its one tunable (aim for about 50%
    acceptance)."""
    U, Gamma, U_t = cov_svd

    def kernel(key: PRNGKey, state: MarginalState, logdensity_fn, delta):
        position = state.position
        U_, Gamma_ = U.to(position), Gamma.to(position)
        keys = chain_keys(key, position)
        proposal_key, accept_key = prng.split(keys).unbind(-2)
        a, gain, mix = _proposal_gains(Gamma_, delta)
        mean_y = gain * (state.U_x / a + state.U_grad_x)
        white = prng.normal(proposal_key, mean_y.shape[keys.dim() - 1:], position.dtype)
        y = (mean_y + torch.sqrt(gain / mix) * white) @ U_.T
        proposed = _spectral_view(logdensity_fn, U_t, y)

        # the Hastings correction h(x, y) - h(y, x), with
        # h(u, v) = <u - gain (v / a + grad_v / 2), mix grad_v>
        def h(u_spec, v_spec, grad_v_spec):
            shadow = gain * (v_spec / a + 0.5 * grad_v_spec)
            return ((u_spec - shadow) * (mix * grad_v_spec)).sum(-1)

        log_p_accept = (
            proposed.logdensity
            - state.logdensity
            + h(state.U_x, proposed.U_x, proposed.U_grad_x)
            - h(proposed.U_x, state.U_x, state.U_grad_x)
        )
        uniform = prng.uniform(accept_key, (), log_p_accept.dtype)
        accepted, (do_accept, p_accept, _) = static_binomial_sampling(
            uniform, log_p_accept, state, proposed
        )
        return accepted, MarginalInfo(p_accept, do_accept, proposed)

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    covariance: Optional[Array] = None,
    mean: Optional[ArrayLikeTree] = None,
    cov_svd: Optional[CovarianceSVD] = None,
    step_size: float = 1.0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.mgrad_gaussian(...)`` for ``q(x) ∝ exp(f(x))
    N(x; m, C)``."""
    if cov_svd is None:
        if covariance is None:
            raise ValueError("Either covariance or cov_svd must be provided.")
        cov_svd = svd_from_covariance(covariance)
    if mean is not None:
        logdensity_fn = generate_mean_shifted_logprob(logdensity_fn, mean, covariance)
    kernel = build_kernel(cov_svd)
    return build_sampling_algorithm(
        kernel, init, logdensity_fn, init_args=(cov_svd.U_t,), kernel_args=(step_size,)
    )
