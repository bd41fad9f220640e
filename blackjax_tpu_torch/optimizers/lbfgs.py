"""L-BFGS with path recording, plus the factored inverse-Hessian algebra
Pathfinder uses (Zhang et al. 2022); reference
``blackjax_tpu/optimizers/lbfgs.py``.

The optimizer is optax's L-BFGS with its zoom line search, here the port's
twins of :mod:`blackjax_tpu_torch.optimizers.optax_twins`, run for
``maxiter`` iterations behind a converged-flag guard. The minimiser runs a
batch of paths at once: ``_minimize_lbfgs_flat`` takes a ``(d,)`` start or
a ``(P, d)`` batch of starts and an objective that maps ``(..., d)`` to
``(...)``; each path stops on its own (its later history entries repeat its
converged iterate, as the reference's ``lax.cond`` under ``vmap`` leaves
them), and the host loop ends when every path has stopped. Histories are
``(maxiter + 1, ...)`` for one path and ``(P, maxiter + 1, ...)`` for a
batch.

The algebra takes one path's ``(d,)`` / ``(d, m)`` arrays or a batch with
leading axes. JAX's ``cholesky`` and ``inv`` return NaN where no factor
exists, and Pathfinder relies on that (a non-finite ELBO makes an iterate
ineligible), so the port uses ``cholesky_ex`` and ``inv_ex`` and writes NaN
where their status says so; neither reads the status back to the host.
"""
from typing import Any, Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.optimizers import optax_twins
from blackjax_tpu_torch.types import Array
from blackjax_tpu_torch.util import require_tensor_position, value_and_grad

__all__ = [
    "LBFGSHistory",
    "LBFGSDiagnostics",
    "LbfgsState",
    "OptStep",
    "minimize_lbfgs",
    "lbfgs_recover_alpha",
    "lbfgs_inverse_hessian_factors",
    "lbfgs_inverse_hessian_formula_1",
    "lbfgs_inverse_hessian_formula_2",
    "bfgs_sample",
]

# the host loop's iterations of every minimisation: each is one L-BFGS step
# of every path still going
HOST_LOOPS = {"lbfgs": 0}


class LBFGSDiagnostics(NamedTuple):
    """Convergence diagnostics of one solve; ``hit_maxiter`` is the
    actionable budget-exhausted signal."""

    iter_num: Array
    error: Array
    converged: Array
    hit_maxiter: Array


class LBFGSHistory(NamedTuple):
    """The optimization path: iterates, objective values, gradients, the
    running diagonal inverse-Hessian estimate, and the per-step mask of
    whether the (s, z) pair passed the curvature condition."""

    x: Array
    f: Array
    g: Array
    alpha: Array
    update_mask: Array


class LbfgsState(NamedTuple):
    iter_num: Array
    value: Array
    grad: Array
    error: Array
    s_history: Array
    y_history: Array
    rho_history: Array
    gamma: Array
    stepsize: Array
    aux: Any


class OptStep(NamedTuple):
    params: Any
    state: LbfgsState


def minimize_lbfgs(
    fun: Callable,
    x0: Array,
    maxiter: int = 30,
    maxcor: int = 10,
    gtol: float = 1e-08,
    ftol: float = 1e-05,
    maxls: int = 1000,
    **lbfgs_kwargs,
) -> tuple[OptStep, LBFGSHistory]:
    """Minimize ``fun`` from ``x0``, recording the whole path. Returns
    ``(OptStep, LBFGSHistory)`` with histories of length ``maxiter + 1``
    (initial point included); entries after convergence repeat the
    converged iterate. ``x0`` is a ``(d,)`` tensor (or a ``(P, d)`` batch of
    starts, each its own path); ``fun`` maps ``(..., d)`` to ``(...)``."""
    require_tensor_position(x0, "minimize_lbfgs")
    return _minimize_lbfgs_flat(fun, x0, maxiter, maxcor, gtol, ftol, maxls)


def _minimize_lbfgs_flat(fun, x0, maxiter, maxcor, gtol, ftol, maxls):
    """The reference's ``scan`` of ``maxiter`` guarded steps (``:135-172``):
    a step evaluates the cached value and gradient, takes optax's L-BFGS
    update with its zoom line search, evaluates the objective at the new
    point and updates the diagonal estimate from this step's pair; the path
    goes on while ``||g|| > gtol`` and the relative drop exceeds ``ftol``.
    The state is read from optax's memory at ``(count - 1) % maxcor``
    (``:175-194``)."""
    single = x0.dim() == 1
    x0 = x0[None] if single else x0
    linesearch = optax_twins.scale_by_zoom_linesearch(max_linesearch_steps=maxls)
    solver = optax_twins.lbfgs(memory_size=maxcor, linesearch=linesearch)
    cached_value_and_grad = optax_twins.value_and_grad_from_state(fun)

    opt_state = solver.init(x0)
    f0, g0 = value_and_grad(fun, x0)
    history = LBFGSHistory(x0, f0, g0, torch.ones_like(x0), torch.zeros_like(x0, dtype=torch.bool))
    records = [history]
    params = x0
    keep_going = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
    for _ in range(maxiter):
        if not bool(keep_going.any()):
            records.append(history)
            continue
        HOST_LOOPS["lbfgs"] += 1
        value, grad = cached_value_and_grad(params, state=opt_state)
        updates, new_state = solver.update(grad, opt_state, params, value=value, grad=grad,
                                           value_fn=fun, active=keep_going)
        new_params = optax_twins.apply_updates(params, updates)
        new_value, new_grad = value_and_grad(fun, new_params)
        # this step's position and gradient deltas (optax's own memory lags
        # by one) feed the streaming diagonal inverse-Hessian estimate
        alpha, mask = lbfgs_recover_alpha(history.alpha, new_params - params, new_grad - grad)
        new_history = LBFGSHistory(new_params, new_value, new_grad, alpha, mask)
        rel_drop = torch.abs(value - new_value) / torch.clamp(
            torch.maximum(torch.abs(value), torch.abs(new_value)), min=1.0)
        going = (torch.linalg.vector_norm(grad, dim=-1) > gtol) & (rel_drop > ftol)
        params, opt_state, history = tree_select(keep_going, (new_params, new_state, new_history),
                                                 (params, opt_state, history))
        keep_going = keep_going & going
        records.append(history)
    history = LBFGSHistory(*(torch.stack(leaves, dim=1) for leaves in zip(*records)))

    inner = opt_state[0]  # the twin of optax's ScaleByLBFGSState
    last_idx = ((inner.count - 1) % maxcor).long()
    rows = torch.arange(x0.shape[0], device=x0.device)
    s_last = inner.diff_params_memory[rows, last_idx]
    y_last = inner.diff_updates_memory[rows, last_idx]
    sy = (s_last * y_last).sum(-1)
    gamma = torch.where(sy > 0, sy / (y_last * y_last).sum(-1), torch.ones_like(sy))
    state = LbfgsState(
        iter_num=inner.count,
        value=history.f[:, -1],
        grad=history.g[:, -1],
        error=torch.linalg.vector_norm(history.g[:, -1], dim=-1),
        s_history=inner.diff_params_memory,
        y_history=inner.diff_updates_memory,
        rho_history=inner.weights_memory,
        gamma=gamma,
        stepsize=torch.ones_like(gamma),
        aux=None,
    )
    step = OptStep(params=params, state=state)
    if single:
        step = OptStep(params[0], LbfgsState(*(None if v is None else v[0] for v in state)))
        history = LBFGSHistory(*(leaf[0] for leaf in history))
    return step, history


def _dot(a, b):
    return (a * b).sum(-1)


def lbfgs_recover_alpha(alpha_prev, s, z, epsilon=1e-12):
    """Streaming diagonal inverse-Hessian estimate (Pathfinder Algorithm 3
    inner loop). The pair is used only when the curvature condition
    ``s.z > eps * ||z||`` holds; otherwise the previous diagonal carries
    over (mask False). Takes ``(d,)`` or ``(P, d)`` rows."""
    a = (alpha_prev * z**2).sum(-1, keepdim=True)
    b = _dot(z, s)[..., None]
    c = (s**2 / alpha_prev).sum(-1, keepdim=True)
    inv_alpha = a / (b * alpha_prev) + z**2 / b - (a * s**2) / (b * c * alpha_prev**2)
    accept = _dot(s, z) > epsilon * torch.linalg.vector_norm(z, dim=-1)
    alpha = torch.where(accept[..., None], 1.0 / inv_alpha, alpha_prev)
    return alpha, accept[..., None].expand_as(alpha_prev)


def _nan_where_failed(x, info):
    """NaN in every entry of the matrices whose factorization failed."""
    return torch.where((info == 0)[..., None, None], x, torch.full_like(x, torch.nan))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def lbfgs_inverse_hessian_factors(S, Z, alpha):
    """Factored inverse Hessian ``H^-1 = diag(alpha) + beta gamma beta^T``
    (Pathfinder formula II.2) from position deltas ``S`` and gradient deltas
    ``Z``, ``(..., d, m)``, and the diagonal ``alpha`` ``(..., d)``."""
    m = S.shape[-1]
    StZ = S.transpose(-1, -2) @ Z
    R = torch.triu(StZ) + _eye(m, S) * torch.finfo(S.dtype).eps
    eta = torch.diagonal(StZ, dim1=-2, dim2=-1)

    beta = torch.cat((alpha[..., None] * Z, S), dim=-1)
    inverse, info = torch.linalg.inv_ex(R)
    neg_Rinv = -_nan_where_failed(inverse, info)
    sqrt_alpha_Z = torch.sqrt(alpha)[..., None] * Z
    inner = sqrt_alpha_Z.transpose(-1, -2) @ sqrt_alpha_Z + torch.diag_embed(eta)
    lower_right = neg_Rinv.transpose(-1, -2) @ inner @ neg_Rinv
    zeros = torch.zeros_like(neg_Rinv)
    gamma = torch.cat((torch.cat((zeros, neg_Rinv), dim=-1),
                       torch.cat((neg_Rinv.transpose(-1, -2), lower_right), dim=-1)), dim=-2)
    return beta, gamma


def lbfgs_inverse_hessian_formula_1(alpha, beta, gamma):
    """Dense ``H^-1`` (formula II.1)."""
    return torch.diag_embed(alpha) + beta @ gamma @ beta.transpose(-1, -2)


def lbfgs_inverse_hessian_formula_2(alpha, beta, gamma):
    """Dense ``H^-1`` in the symmetric sqrt-alpha form (formula II.3)."""
    d = alpha.shape[-1]
    sqrt_a = torch.diag_embed(torch.sqrt(alpha))
    inv_sqrt_a = torch.diag_embed(1.0 / torch.sqrt(alpha))
    return sqrt_a @ (_eye(d, alpha) + inv_sqrt_a @ beta @ gamma @ beta.transpose(-1, -2)
                     @ inv_sqrt_a) @ sqrt_a


def _householder_qr(a):
    """The thin QR factorization of ``(..., n, k)`` matrices, ``Q (..., n,
    r)`` and ``R (..., r, k)`` with ``r = min(n, k)``, by LAPACK's
    Householder reflections (``geqr2``'s ``larfg`` and ``larf``, then
    ``orgqr``'s backward accumulation): a reflector a column, ``tau = 0``
    where the column is already reduced, ``R``'s diagonal ``-sign(a_jj)
    ||a_j:||``. ``torch.linalg.qr`` on the card factors a batch one matrix
    at a time (a few launches each: about 1.5 million for Pathfinder's 4,096
    paths x 31 iterates); these are about 15 batched ops a column."""
    n, k = a.shape[-2:]
    r = min(n, k)
    rows = torch.arange(n, device=a.device)
    reflectors, diagonal = [], []
    for j in range(r):
        column = a[..., j]
        head = column[..., j]
        below = rows > j
        tail = torch.where(below, column, torch.zeros_like(column))
        xnorm = torch.linalg.vector_norm(tail, dim=-1)
        beta = -torch.copysign(torch.hypot(head, xnorm), head)
        reflect = xnorm != 0
        tau = torch.where(reflect, (beta - head) / beta, torch.zeros_like(head))
        unit = (rows == j).to(a.dtype)
        scale = torch.where(reflect, 1.0 / (head - beta), torch.zeros_like(head))
        v = torch.where(below, tail * scale[..., None], unit)
        a = a - (tau[..., None] * v)[..., :, None] * (v[..., None, :] @ a)
        reflectors.append((tau, v))
        diagonal.append(torch.where(reflect, beta, head))
    R = torch.triu(a[..., :r, :])
    steps = torch.arange(r, device=a.device)
    R[..., steps, steps] = torch.stack(diagonal, dim=-1)
    Q = torch.eye(n, r, dtype=a.dtype, device=a.device).expand(a.shape[:-2] + (n, r))
    for tau, v in reversed(reflectors):
        Q = Q - (tau[..., None] * v)[..., :, None] * (v[..., None, :] @ Q)
    return Q, R


def bfgs_sample(rng_key, num_samples, position, grad_position, alpha, beta, gamma):
    """Sample from the factored Gaussian ``N(mu, H^-1)`` with
    ``mu = x + H^-1 g`` (Pathfinder Algorithm 4). Returns ``(samples, their
    log-densities under the approximation)``: ``(*num_samples, d)`` and
    ``num_samples`` for one path, with the paths' axes in front for a batch
    of ``(..., d)`` positions and ``(..., 2)`` keys (a key a path). The
    normals are ``prng.normal(key, num_samples + (d, 1))``, the reference's
    draws."""
    if not isinstance(num_samples, tuple):
        num_samples = (num_samples,)
    batch = position.dim() - 1
    Q, R = _householder_qr(beta / torch.sqrt(alpha)[..., None])
    d = beta.shape[-2]
    identity = _eye(R.shape[-2], R)
    L, info = torch.linalg.cholesky_ex(identity + R @ gamma @ R.transpose(-1, -2))
    L = _nan_where_failed(L, info)

    logdet = torch.log(alpha).sum(-1) + 2.0 * torch.log(
        torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    mu = position + alpha * grad_position + (
        beta @ (gamma @ (beta.transpose(-1, -2) @ grad_position[..., None])))[..., 0]

    u = prng.normal(rng_key, num_samples + (d, 1), position.dtype)[..., 0]
    # the reference's Q (L - I) (Q^T u) on (d, 1) columns, here on the rows
    # of each path's (draws, d) block: two batched products a path
    rows = u.reshape(u.shape[:batch] + (-1, d))
    Qt_u = rows @ Q
    correction = (Qt_u @ (Q @ (L - identity)).transpose(-1, -2)).reshape(u.shape)
    expand = (slice(None),) * batch + (None,) * len(num_samples)
    phi = mu[expand] + torch.sqrt(alpha)[expand] * (correction + u)
    logdensity = -0.5 * (logdet[expand] + (u * u).sum(-1) + d * torch.log(
        torch.tensor(2.0 * torch.pi, dtype=position.dtype, device=position.device)))
    return phi, logdensity
