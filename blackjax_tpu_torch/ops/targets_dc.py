"""Matrix-class targets of the continuous NUTS machine: Bayesian logistic
regression, the Finnish (regularized) horseshoe and non-centered eight
schools.

Port of ``blackjax_tpu/ops/targets_dc.py``. Each target folds every
``y``-dependent contraction into host vectors, as the reference does:

- logistic regression: ``sum_n y_n logit_n = (X^T y) . w`` and ``grad = X^T y
  - X^T sigmoid(X w) - w / s^2``, so the machine sees ``y`` only through
  ``v = X^T y``;
- horseshoe: ``SSR = yy - 2 (u . beta + alpha sy) + sum_n q_n^2 + 2 alpha
  (s . beta + N alpha / 2)`` with ``q = X beta``, ``u = X^T y``, ``s = X^T 1``;
  the residual is never formed.

Each gradient is two contractions with the data, ``X @ beta`` and ``X^T @
(.)``. The plain ``value_and_grad`` of each target (the CPU path and the
kernel's reference on the card) keeps the reference tiles' formulas and
operation order (``_core``, ``_value``, ``_grad``), folded host vectors and
the zero-padding constant included; its contractions are ``torch.matmul``.
The device functions of the same targets are in ``csrc/matrix_targets.cuh``.
"""
import math

import numpy as np
import torch

from blackjax_tpu_torch.models.targets import horseshoe_data
from blackjax_tpu_torch.ops.fused_nuts_dc import (
    MatrixTargetData,
    TargetKernelDC,
    _CUDA_EIGHT_SCHOOLS,
    _CUDA_HORSESHOE,
    _CUDA_LOGREG,
    _logaddexp,
    _on_device,
    _round_up,
)

__all__ = [
    "make_logreg_target_dc",
    "logreg_target_dc_from_params",
    "make_finnish_horseshoe_target_dc",
    "make_eight_schools_target_dc",
    "horseshoe_dc_perm",
    "eight_schools_dc_perm",
]

_SUBLANE = 8


def make_logreg_target_dc(X, y, prior_scale: float = 10.0) -> TargetKernelDC:
    """Bayesian logistic regression ``w ~ N(0, prior_scale^2 I)``, ``y_i ~
    Bernoulli(sigmoid(x_i . w))``."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32).reshape(-1)
    n_data, dim = X.shape
    X_pad = np.zeros((_round_up(n_data, _SUBLANE), _round_up(dim, _SUBLANE)), np.float32)
    X_pad[:n_data, :dim] = X
    v = X.T @ y  # (dim,): the only y the machine sees
    return logreg_target_dc_from_params(dim, v, X_pad, n_data, prior_scale)


def logreg_target_dc_from_params(dim: int, v, X_pad, num_points: int,
                                 prior_scale: float = 10.0) -> TargetKernelDC:
    """The logistic-regression target from the reference's ``params``
    ``(v, X_pad)`` and the number of real data rows."""
    v = np.asarray(v, np.float32).reshape(-1)
    X_pad = np.asarray(X_pad, np.float32)
    n_pad = X_pad.shape[0]
    if v.shape != (dim,) or X_pad.shape[1] < dim or not 0 < num_points <= n_pad:
        raise ValueError(f"logreg params {v.shape}, {X_pad.shape} do not fit dim {dim}, "
                         f"{num_points} points")
    inv_pv = 1.0 / float(prior_scale) ** 2
    # padded X rows give logits exactly 0, so softplus adds log 2 for each
    pad_const = float((n_pad - num_points) * math.log(2.0))
    X_op = np.ascontiguousarray(X_pad[:, :dim])  # (n_pad, dim)
    data = _on_device(v, X_op)

    def _core(w, v_row, X_op):
        logits = w @ X_op.T  # (C, n_pad)
        sig = torch.sigmoid(logits)
        softplus = _logaddexp(torch.zeros_like(logits), logits).sum(1)
        yxw = (v_row * w).sum(1)
        prior = -0.5 * inv_pv * (w * w).sum(1)
        return yxw - (softplus - pad_const) + prior, sig

    def value_and_grad(x):
        v_row, X_op = data(x)
        ld, sig = _core(x, v_row, X_op)
        xts = sig @ X_op  # (C, dim)
        return ld, v_row - xts - inv_pv * x

    def logdensity_fn(w):
        # sum_n y_n logit_n is v . w
        v_row, X_op = data(w)
        logits = w @ X_op[:num_points].T
        loglik = (v_row * w).sum(-1) - _logaddexp(torch.zeros_like(logits), logits).sum(-1)
        return loglik - 0.5 * inv_pv * (w**2).sum(-1)

    return TargetKernelDC(
        name="logreg_dc",
        dim=dim,
        value_and_grad=value_and_grad,
        logdensity_fn=logdensity_fn,
        cuda_target=_CUDA_LOGREG,
        params=(v, X_pad),
        matrix=MatrixTargetData(
            X=X_op, u=v, s=None, scalars=(inv_pv, -0.5 * inv_pv, pad_const)),
    )


def horseshoe_dc_perm(num_predictors: int):
    """Index permutations between the model layout of
    :func:`blackjax_tpu_torch.models.targets.finnish_horseshoe` (``[alpha,
    log_sigma, log_tau, log_c2, log_lam(M), beta_t(M)]``) and the machine's
    layout (``[log_lam(M), beta_t(M), alpha, log_sigma, log_tau,
    log_c2]``). Returns ``(to_dc, from_dc)``: ``x_dc = x_model[to_dc]``,
    ``x_model = x_dc[from_dc]``."""
    M = num_predictors
    to_dc = np.concatenate([np.arange(4, 4 + 2 * M), np.arange(4)])
    return to_dc, np.argsort(to_dc)


def make_finnish_horseshoe_target_dc(
    num_points: int = 100,
    num_predictors: int = 200,
    expected_nonzero: int = 10,
    slab_scale: float = 3.0,
    slab_df: float = 25.0,
    seed: int = 42,
    X=None,
    y=None,
) -> TargetKernelDC:
    """Regularized ("Finnish") horseshoe sparse regression in the machine's
    layout: the posterior of :func:`~blackjax_tpu_torch.models.targets
    .finnish_horseshoe` (same default dataset) under
    :func:`horseshoe_dc_perm`. Requires ``num_predictors % 8 == 0``, as the
    reference does."""
    M, N = num_predictors, num_points
    if M % _SUBLANE:
        raise ValueError(f"num_predictors must be a multiple of 8, got {M}")
    if X is None or y is None:
        X, y = horseshoe_data(N, M, seed)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32).reshape(-1)
    dim = 2 * M + 4

    tau0 = float(expected_nonzero / ((M - expected_nonzero) * np.sqrt(N)))
    half_df = 0.5 * float(slab_df)
    slab2 = float(slab_scale) ** 2

    X_pad = np.zeros((_round_up(N, _SUBLANE), M), np.float32)
    X_pad[:N] = X
    u = X.T @ y  # (M,)
    s = X.sum(axis=0)  # (M,) = X^T 1
    sy = float(y.sum())
    yy = float((y * y).sum())
    data = _on_device(u, s, X_pad)

    def _core(x, u_row, s_row, X_op):
        """What the value and the gradient share, with the one ``X @
        beta`` contraction; per-chain scalars are ``(C, 1)`` columns."""
        log_lam, beta_t = x[:, 0:M], x[:, M:2 * M]
        alpha, log_sigma = x[:, 2 * M:2 * M + 1], x[:, 2 * M + 1:2 * M + 2]
        log_tau, log_c2 = x[:, 2 * M + 2:2 * M + 3], x[:, 2 * M + 3:2 * M + 4]
        sigma = torch.exp(log_sigma)
        inv_s2 = torch.exp(-2.0 * log_sigma)
        tau = tau0 * sigma * torch.exp(log_tau)
        c2 = slab2 * torch.exp(log_c2)
        lam2 = torch.exp(2.0 * log_lam)
        denom = c2 + tau**2 * lam2
        lam_reg = torch.sqrt(c2 * lam2 / denom)
        beta = tau * lam_reg * beta_t

        q = beta @ X_op.T  # (C, n_pad); padded rows give 0
        sum_q = q.sum(1, keepdim=True)
        sum_q2 = (q * q).sum(1, keepdim=True)
        u_beta = (u_row * beta).sum(1, keepdim=True)
        s_beta = (s_row * beta).sum(1, keepdim=True)
        ssr = yy - 2.0 * (u_beta + alpha * sy) + sum_q2 + 2.0 * alpha * (s_beta + 0.5 * N * alpha)
        return dict(
            log_lam=log_lam, beta_t=beta_t, alpha=alpha, log_sigma=log_sigma,
            log_tau=log_tau, log_c2=log_c2, sigma=sigma, inv_s2=inv_s2, tau=tau,
            c2=c2, lam2=lam2, denom=denom, lam_reg=lam_reg, beta=beta, q=q,
            sum_q=sum_q, ssr=ssr,
        )

    def _value(c):
        loglik = -N * c["log_sigma"] - 0.5 * c["ssr"] * c["inv_s2"]
        lp = -0.125 * c["alpha"] ** 2
        lp = lp + (-0.125 * c["sigma"] ** 2 + c["log_sigma"])
        lp = lp + (-torch.log1p(torch.exp(2.0 * c["log_tau"])) + c["log_tau"])
        lp = lp + (-half_df * c["log_c2"] - half_df * torch.exp(-c["log_c2"]))
        lp = lp + (-torch.log1p(c["lam2"]) + c["log_lam"]).sum(1, keepdim=True)
        lp = lp + -0.5 * (c["beta_t"] ** 2).sum(1, keepdim=True)
        return (lp + loglik)[:, 0]

    def _grad(c, u_row, s_row, X_op):
        """Chain rule through ``beta = tau * lam_reg(tau, c2, lam) *
        beta_t``; every likelihood path flows through ``g_beta = (u - X^T q
        - alpha s) / sigma^2``, the second contraction."""
        xtq = c["q"] @ X_op  # (C, M)
        g_beta = (u_row - xtq - c["alpha"] * s_row) * c["inv_s2"]
        frac = c["c2"] / c["denom"]
        g_beta_t = g_beta * c["tau"] * c["lam_reg"] - c["beta_t"]
        g_log_lam = g_beta * c["beta"] * frac + 1.0 - 2.0 * c["lam2"] / (1.0 + c["lam2"])
        t_lik = (g_beta * c["beta"] * frac).sum(1, keepdim=True)
        g_alpha = (sy - c["sum_q"] - N * c["alpha"]) * c["inv_s2"] - 0.25 * c["alpha"]
        g_log_tau = t_lik + 1.0 - 2.0 * torch.sigmoid(2.0 * c["log_tau"])
        g_log_c2 = (
            (g_beta * c["beta"] * (c["tau"] ** 2 * c["lam2"]) / (2.0 * c["denom"]))
            .sum(1, keepdim=True)
            - half_df
            + half_df * torch.exp(-c["log_c2"])
        )
        g_log_sigma = -N + c["ssr"] * c["inv_s2"] + t_lik - 0.25 * c["sigma"] ** 2 + 1.0
        return torch.cat([g_log_lam, g_beta_t, g_alpha, g_log_sigma, g_log_tau, g_log_c2], dim=1)

    def value_and_grad(x):
        u_row, s_row, X_op = data(x)
        c = _core(x, u_row, s_row, X_op)
        return _value(c), _grad(c, u_row, s_row, X_op)

    def logdensity_fn(x):
        """The machine-layout log density, with the residual formed."""
        X_t, y_t = (torch.from_numpy(a).to(device=x.device, dtype=x.dtype) for a in (X, y))
        log_lam, beta_t = x[..., 0:M], x[..., M:2 * M]
        alpha, log_sigma = x[..., 2 * M], x[..., 2 * M + 1]
        log_tau, log_c2 = x[..., 2 * M + 2], x[..., 2 * M + 3]
        sigma = torch.exp(log_sigma)
        tau = tau0 * sigma * torch.exp(log_tau)
        c2 = slab2 * torch.exp(log_c2)[..., None]
        lam2 = torch.exp(2.0 * log_lam)
        lam_reg = torch.sqrt(c2 * lam2 / (c2 + tau[..., None] ** 2 * lam2))
        beta = tau[..., None] * lam_reg * beta_t
        resid = y_t - (beta @ X_t.T + alpha[..., None])
        loglik = -N * log_sigma - 0.5 * ((resid / sigma[..., None]) ** 2).sum(-1)
        lp = -0.125 * alpha**2
        lp = lp + (-0.125 * sigma**2 + log_sigma)
        lp = lp + (-torch.log1p(torch.exp(2.0 * log_tau)) + log_tau)
        lp = lp + (-half_df * log_c2 - half_df * torch.exp(-log_c2))
        lp = lp + (-torch.log1p(lam2) + log_lam).sum(-1)
        lp = lp - 0.5 * (beta_t**2).sum(-1)
        return lp + loglik

    return TargetKernelDC(
        name=f"finnish_horseshoe_dc_{N}x{M}",
        dim=dim,
        value_and_grad=value_and_grad,
        logdensity_fn=logdensity_fn,
        cuda_target=_CUDA_HORSESHOE,
        params=(u, s, X_pad),
        matrix=MatrixTargetData(
            X=np.ascontiguousarray(X), u=u, s=s,
            scalars=(tau0, half_df, slab2, yy, sy, float(N), 0.5 * N)),
    )


def eight_schools_dc_perm():
    """Index permutations between the model layout of
    :func:`~blackjax_tpu_torch.models.targets.eight_schools_noncentered`
    (``[mu, log_tau, z(8)]``) and the machine's layout (``[z(8), mu,
    log_tau]``). Returns ``(to_dc, from_dc)``."""
    to_dc = np.concatenate([np.arange(2, 10), np.arange(2)])
    return to_dc, np.argsort(to_dc)


def make_eight_schools_target_dc() -> TargetKernelDC:
    """Non-centered eight schools in the machine's layout (d = 10): the
    posterior of ``eight_schools_noncentered`` under
    :func:`eight_schools_dc_perm`."""
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32)
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], np.float32)
    inv_s2 = (1.0 / sigma**2).astype(np.float32)
    data = _on_device(y, inv_s2)

    def value_and_grad(x):
        y_row, is2_row = data(x)
        z, mu, log_tau = x[:, 0:8], x[:, 8:9], x[:, 9:10]
        tau = torch.exp(log_tau)
        r = (y_row - mu - tau * z) * is2_row  # weighted residual
        resid = y_row - mu - tau * z
        lp = -0.02 * mu**2 - 0.02 * log_tau**2
        lp = lp + -0.5 * (z * z).sum(1, keepdim=True)
        lp = lp + -0.5 * (resid * r).sum(1, keepdim=True)
        g_z = -z + r * tau
        g_mu = -0.04 * mu + r.sum(1, keepdim=True)
        g_lt = -0.04 * log_tau + tau * (r * z).sum(1, keepdim=True)
        return lp[:, 0], torch.cat([g_z, g_mu, g_lt], dim=1)

    def logdensity_fn(x):
        y_t, is2 = (torch.from_numpy(a).to(device=x.device, dtype=x.dtype) for a in (y, inv_s2))
        z, mu, log_tau = x[..., 0:8], x[..., 8], x[..., 9]
        theta = mu[..., None] + torch.exp(log_tau)[..., None] * z
        lp = -0.02 * mu**2 - 0.02 * log_tau**2
        lp = lp - 0.5 * (z**2).sum(-1)
        return lp + (-0.5 * (y_t - theta) ** 2 * is2).sum(-1)

    return TargetKernelDC(
        name="eight_schools_dc",
        dim=10,
        value_and_grad=value_and_grad,
        logdensity_fn=logdensity_fn,
        cuda_target=_CUDA_EIGHT_SCHOOLS,
        params=(y, inv_s2),
        matrix=MatrixTargetData(X=None, u=y, s=inv_s2, scalars=()),
    )
