"""Fused multi-step leapfrog for registered analytic targets: one CUDA kernel
runs a whole velocity-Verlet trajectory per chain.

Port of ``blackjax_tpu/ops/fused_leapfrog.py`` (``fused_leapfrog`` and its
Pallas kernel ``_leapfrog_kernel``). Two implementations of the same
trajectory live here:

- the CUDA kernel ``csrc/fused_leapfrog.cu`` (one warp per chain), launched
  for CUDA tensors;
- :func:`fused_leapfrog_plain`, the plain PyTorch version on the ``(C, d)``
  block, taken for CPU tensors and used on the card as the kernel's
  reference.

Both keep the Pallas kernel's operation order (``m + (0.5 * eps) * g``,
``x + eps * (m * imm)`` and the tile functions' own expressions), so they
round alike except for the order of their sums.

The same library also runs a whole ``fused_hmc`` transition in one launch
for the analytic targets (``hmc_transition`` in
``csrc/fused_leapfrog.cu``: the momentum from the draws, both energies, the
trajectory and the Metropolis accept); :func:`_hmc_transition_plain` is its
plain version, the reference's step term by term over
:func:`fused_leapfrog_plain`. ``ops.fused_hmc`` picks between them.

Ported: the hierarchical, Gaussian and logistic-regression targets, ``d <=
256`` on the card. Logistic regression computes its two ``(C, N) x (N, d)``
contractions inside the kernel in the tiles form (``csrc/matrix_targets.cuh``:
``logreg_tiles``): the chains of a block share each gradient, and X streams
through shared memory in tiles of rows, read from L2 once a gradient for the
whole block; :func:`tiles_plan` gives the layout and :data:`LAUNCHES` counts
the form. Its plain version keeps the reference's spelling (data axis padded
to 128, a row mask, ``y * logits - logaddexp(0, logits)``). ``tile_chains``
is accepted and ignored: chains are independent on the GPU.
"""
import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from blackjax_tpu_torch.ops import _nvcc
from blackjax_tpu_torch.ops.fused_nuts_dc import (
    MatrixTargetData,
    _logaddexp,
    _lr_tiles,
    _matrix_on,
    _on_device,
)

__all__ = [
    "LAUNCHES",
    "TargetKernel",
    "TilesPlan",
    "build",
    "fused_leapfrog",
    "fused_leapfrog_plain",
    "gaussian_target_from_params",
    "get_registered_target",
    "make_gaussian_target",
    "make_hierarchical_gaussian_target",
    "make_logistic_regression_target",
    "register_target",
    "tiles_plan",
]

# kernel launches of the library, by kernel name; a launch on logistic
# regression also counts under its form, the tiles form, and a launch of the
# HMC transition under its own
LAUNCHES = {"fused_leapfrog": 0, "fused_leapfrog:logreg_tiles": 0,
            "fused_leapfrog:hmc_transition": 0}

# the target ids of csrc/analytic_targets.cuh and csrc/matrix_targets.cuh
_CUDA_HIERARCHICAL = 0
_CUDA_GAUSSIAN = 1
_CUDA_LOGISTIC_REGRESSION = 2
_LANE = 128
_MAX_CUDA_DIM = 256  # eight registers per lane and vector


@dataclass(frozen=True, eq=False)
class TargetKernel:
    """An analytic target of the fused leapfrog.

    ``logdensity_tile(x) -> (C,)`` and ``grad_tile(x) -> (C, d)`` are the
    plain PyTorch versions on an f32 ``(C, d)`` block, written as the
    reference's tile functions are; ``logdensity_fn`` is the plain
    logdensity of ``(..., d)`` positions; ``cuda_target`` names the same
    target's device functions in ``csrc/fused_leapfrog.cu``; ``params`` are
    its host values as the reference's (the Gaussian's inverse variances,
    logistic regression's padded data); ``matrix`` is what a matrix
    target's device function reads.
    """

    name: str
    dim: int
    logdensity_tile: Callable
    grad_tile: Callable
    logdensity_fn: Callable
    cuda_target: int
    params: tuple = ()
    matrix: Optional[MatrixTargetData] = None


_REGISTRY: dict = {}


def register_target(target: TargetKernel) -> TargetKernel:
    _REGISTRY[(target.name, target.dim)] = target
    return target


def get_registered_target(name: str, dim: int) -> TargetKernel:
    try:
        return _REGISTRY[(name, dim)]
    except KeyError:
        raise ValueError(
            f"No registered target kernel {name!r} at dim={dim}; available: "
            f"{sorted(_REGISTRY)}"
        ) from None


def make_hierarchical_gaussian_target(dim: int) -> TargetKernel:
    """The flagship hierarchical Gaussian ``x = (log_tau, theta)``:
    ``log_tau ~ N(0, 1)``, ``theta_i | log_tau ~ N(0, e^{log_tau})``."""
    n_theta = dim - 1

    def masks(x):
        theta_mask = torch.ones(dim, dtype=x.dtype, device=x.device)
        theta_mask[0] = 0.0
        return 1.0 - theta_mask, theta_mask

    def logdensity_tile(x):
        _, theta_mask = masks(x)
        log_tau = x[:, 0]
        theta_sq = ((x * theta_mask) ** 2).sum(1)
        return (
            -0.5 * log_tau**2
            - 0.5 * theta_sq * torch.exp(-log_tau)
            - 0.5 * n_theta * log_tau
        )

    def grad_tile(x):
        is_tau, theta_mask = masks(x)
        log_tau = x[:, 0:1]
        exp_neg = torch.exp(-log_tau)
        theta_sq = ((x * theta_mask) ** 2).sum(1, keepdim=True)
        g_tau = -log_tau + 0.5 * theta_sq * exp_neg - 0.5 * n_theta
        g_theta = -(x * theta_mask) * exp_neg
        return is_tau * g_tau + g_theta

    def logdensity_fn(x):
        log_tau = x[..., 0]
        theta = x[..., 1:]
        return (
            -0.5 * log_tau**2
            - 0.5 * (theta**2).sum(-1) * torch.exp(-log_tau)
            - 0.5 * n_theta * log_tau
        )

    return register_target(
        TargetKernel(
            name="hierarchical_gaussian",
            dim=dim,
            logdensity_tile=logdensity_tile,
            grad_tile=grad_tile,
            logdensity_fn=logdensity_fn,
            cuda_target=_CUDA_HIERARCHICAL,
        )
    )


def make_gaussian_target(dim: int, variances=None) -> TargetKernel:
    """Independent Gaussian ``N(0, diag(variances))``; the variances may be a
    ladder, as the ill-conditioned Gaussian's."""
    if variances is None:
        inv_var_host = torch.ones(dim, dtype=torch.float32)
    else:
        inv_var_host = 1.0 / torch.as_tensor(variances, dtype=torch.float32).cpu()
    return gaussian_target_from_params(dim, tuple(float(v) for v in inv_var_host.reshape(-1)))


def gaussian_target_from_params(dim: int, inv_var_param: tuple) -> TargetKernel:
    """The Gaussian target from its f32 inverse variances, as the
    reference's ``make_gaussian_target(...).params[0]`` holds them."""
    if len(inv_var_param) != dim:
        raise ValueError(f"{len(inv_var_param)} inverse variances for dim {dim}")

    def inv_var(x):
        return torch.tensor(inv_var_param, dtype=x.dtype, device=x.device)

    def logdensity_tile(x):
        return -0.5 * (x * x * inv_var(x)).sum(1)

    def grad_tile(x):
        return -x * inv_var(x)

    def logdensity_fn(x):
        return -0.5 * (x**2 * inv_var(x)).sum(-1)

    return register_target(
        TargetKernel(
            name="gaussian",
            dim=dim,
            logdensity_tile=logdensity_tile,
            grad_tile=grad_tile,
            logdensity_fn=logdensity_fn,
            cuda_target=_CUDA_GAUSSIAN,
            params=(inv_var_param,),
        )
    )


def make_logistic_regression_target(X, y, prior_scale: float = 10.0) -> TargetKernel:
    """Bayesian logistic regression ``w ~ N(0, prior_scale^2 I)``, ``y_i ~
    Bernoulli(sigmoid(x_i . w))``: each gradient is two ``(C, N) x (N, d)``
    contractions. As in the reference, the data axis is padded to 128 and a
    row mask removes the padded rows from the likelihood."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32).reshape(-1)
    n_data, dim = X.shape
    inv_prior_var = 1.0 / float(prior_scale) ** 2
    n_pad = -(-n_data // _LANE) * _LANE
    X_full = np.zeros((n_pad, dim), np.float32)
    X_full[:n_data] = X
    y_row = np.zeros((1, n_pad), np.float32)
    y_row[0, :n_data] = y
    row_mask = np.zeros((1, n_pad), np.float32)
    row_mask[0, :n_data] = 1.0
    data = _on_device(X_full, y_row, row_mask, X, y)

    def logdensity_tile(w):
        X_pad, y_pad, valid, _, _ = data(w)
        logits = w @ X_pad.T  # (C, n_pad)
        loglik = valid * (y_pad * logits - _logaddexp(torch.zeros_like(logits), logits))
        prior = -0.5 * inv_prior_var * (w * w).sum(1)
        return loglik.sum(1) + prior

    def grad_tile(w):
        X_pad, y_pad, valid, _, _ = data(w)
        resid = valid * (y_pad - torch.sigmoid(w @ X_pad.T))  # (C, n_pad)
        return resid @ X_pad - inv_prior_var * w

    def logdensity_fn(w):
        _, _, _, X_t, y_t = data(w)
        logits = w @ X_t.T
        loglik = (y_t * logits - _logaddexp(torch.zeros_like(logits), logits)).sum(-1)
        return loglik - 0.5 * inv_prior_var * (w**2).sum(-1)

    return register_target(
        TargetKernel(
            name="logistic_regression",
            dim=dim,
            logdensity_tile=logdensity_tile,
            grad_tile=grad_tile,
            logdensity_fn=logdensity_fn,
            cuda_target=_CUDA_LOGISTIC_REGRESSION,
            params=(X_full, y_row, row_mask),
            matrix=MatrixTargetData(
                X=X, u=y, s=None, scalars=(inv_prior_var, -0.5 * inv_prior_var)),
        )
    )


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _trajectory_plain(x, m, imm, step_size, *, target, num_steps):
    """``num_steps`` velocity-Verlet steps on the f32 block, in the Pallas
    kernel's order, and the endpoint energy ``-logp + 0.5 m^T M^-1 m``."""
    eps = torch.tensor(step_size, dtype=torch.float32, device=x.device)
    g = target.grad_tile(x)
    for _ in range(num_steps):
        m = m + 0.5 * eps * g
        x = x + eps * (m * imm)
        g = target.grad_tile(x)
        m = m + 0.5 * eps * g
    kinetic = 0.5 * (m * m * imm).sum(1)
    return x, m, -target.logdensity_tile(x) + kinetic


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=1)
def _library():
    lib = _nvcc.load("fused_leapfrog")
    lib.bjt_fused_leapfrog.argtypes = [_VP] * 9 + [_INT] * 5 + [ctypes.c_float] * 3 + [_VP]
    lib.bjt_fused_leapfrog.restype = _INT
    lib.bjt_hmc_transition.argtypes = [_VP] * 11 + [_INT] * 4 + [ctypes.c_float, _VP]
    lib.bjt_hmc_transition.restype = _INT
    lib.bjt_fused_tiles_layout.argtypes = [_INT, _VP]
    lib.bjt_fused_tiles_layout.restype = _INT
    lib.bjt_error_string.argtypes = [_INT]
    lib.bjt_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (or load) the kernel library; returns the compiler's report of
    registers, shared memory and spills per kernel."""
    _library()
    return _nvcc.build_log("fused_leapfrog")


@functools.lru_cache(maxsize=16)
def _params_on(params: tuple, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A host vector (a target's parameters, tracked dims) as a tensor on
    ``device``, copied once (a copy per launch would cost more than the
    kernel). Read only."""
    return torch.tensor(params, dtype=dtype, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


class TilesPlan(NamedTuple):
    """The tiles form's layout at a width (``fused_lr_layout`` in
    ``csrc/matrix_targets.cuh``): chains a block, rows of X a tile, and the
    bytes of a block's dynamic shared memory."""

    chains: int
    tile_rows: int
    nbytes: int


@functools.lru_cache(maxsize=16)
def tiles_plan(d: int) -> TilesPlan:
    """The layout of the fused kernels' tiles form for a ``d``-column X, as
    the kernels count it: read from the leapfrog's library
    (``bjt_fused_tiles_layout``), which both kernels' launches consult, so
    it builds that library first."""
    out = (ctypes.c_longlong * 3)()
    if _library().bjt_fused_tiles_layout(d, out) != 0:
        raise ValueError(f"the tiles form takes 1 <= d <= {_MAX_CUDA_DIM}; got d={d}")
    return TilesPlan(*out)


@functools.lru_cache(maxsize=8)
def _tiles_on(target: TargetKernel, device: torch.device, tile_rows: int):
    """Logistic regression's X as tiles of ``tile_rows`` rows (zero padded
    to whole tiles, rows at the tiles form's stride) and y, on ``device``,
    copied once."""
    m = target.matrix
    tiles = torch.from_numpy(_lr_tiles(m.X, tile_rows)).to(device)
    return tiles, torch.from_numpy(np.ascontiguousarray(m.u, np.float32)).to(device)


def _inv_var(target: TargetKernel, dev, d: int):
    """The Gaussian's inverse variances on ``dev``, or None."""
    if not target.params:
        return None
    inv_var = _params_on(target.params[0], dev)
    _nvcc.require_cuda_f32("inv_var", inv_var, dev, (d,))
    return inv_var


def _target_args(target: TargetKernel, dev, d: int):
    """What a launch of the per-warp form passes for ``target`` (the older
    NUTS machine's): the Gaussian's inverse variances on ``dev`` (or None),
    logistic regression's ``(X, X^T, y)`` on ``dev`` (or Nones), its number
    of data rows and its two scalars ``(1 / prior_scale^2, -0.5 /
    prior_scale^2)``."""
    if target.matrix is not None:
        X, Xt, y, _ = _matrix_on(target, dev)
        return None, (X, Xt, y), X.shape[0], target.matrix.scalars
    return _inv_var(target, dev, d), (None, None, None), 0, (0.0, 0.0)


def _tiles_target_args(target: TargetKernel, dev, d: int):
    """What a launch of the leapfrog or the MCLMC kernel passes for
    ``target``: as :func:`_target_args`, but logistic regression's X as the
    tiles form reads it (tiles of :func:`tiles_plan`'s rows) and y,
    ``(tiles, y)``."""
    if target.matrix is not None:
        tiles, y = _tiles_on(target, dev, tiles_plan(d).tile_rows)
        return None, (tiles, y), target.matrix.X.shape[0], target.matrix.scalars
    return _inv_var(target, dev, d), (None, None), 0, (0.0, 0.0)


def _launch_cuda(x, m, imm, step_size, *, target, num_steps):
    C, d = x.shape
    if d > _MAX_CUDA_DIM:
        raise ValueError(
            f"the CUDA leapfrog holds d <= {_MAX_CUDA_DIM} per warp; got d={d}"
        )
    dev = x.device
    for name, t, shape in [("positions", x, (C, d)), ("momenta", m, (C, d)),
                           ("inverse_mass_matrix", imm, (d,))]:
        _nvcc.require_cuda_f32(name, t, dev, shape)
    inv_var, matrix, rows, k = _tiles_target_args(target, dev, d)
    lib = _library()
    out_x, out_m = torch.empty_like(x), torch.empty_like(m)
    energy = torch.empty(C, dtype=torch.float32, device=dev)
    code = lib.bjt_fused_leapfrog(
        x.data_ptr(), m.data_ptr(), imm.data_ptr(), *map(_ptr, (inv_var, *matrix)),
        out_x.data_ptr(), out_m.data_ptr(), energy.data_ptr(),
        C, d, num_steps, target.cuda_target, rows, float(step_size), *k,
        _nvcc.stream_handle(dev),
    )
    _nvcc.check_launch(lib, code, "fused_leapfrog")
    LAUNCHES["fused_leapfrog"] += 1
    if target.matrix is not None:
        LAUNCHES["fused_leapfrog:logreg_tiles"] += 1
    return out_x, out_m, energy


def _prepare(positions, momenta, inverse_mass_matrix, target):
    C, d = positions.shape
    if d != target.dim:
        raise ValueError(f"positions dim {d} != registered target dim {target.dim}")
    if tuple(momenta.shape) != (C, d):
        raise ValueError(f"momenta {tuple(momenta.shape)} != positions {(C, d)}")
    dev = positions.device
    x = positions.to(torch.float32).contiguous()
    m = momenta.to(device=dev, dtype=torch.float32).contiguous()
    imm = torch.as_tensor(inverse_mass_matrix).to(device=dev, dtype=torch.float32)
    return x, m, torch.broadcast_to(imm, (d,)).contiguous()


def fused_leapfrog(
    positions,
    momenta,
    inverse_mass_matrix,
    step_size,
    *,
    target: TargetKernel,
    num_steps: int,
    tile_chains: int = 256,
):
    """Run ``num_steps`` velocity-Verlet steps for every chain.

    ``positions`` and ``momenta`` are ``(C, d)``, ``inverse_mass_matrix`` a
    ``(d,)`` diagonal (or a scalar). Returns ``(positions, momenta,
    energy)`` as f32, with ``energy = -logdensity(x_end) + KE(m_end)`` per
    chain: everything the Metropolis accept needs.

    A CUDA tensor launches the kernel (``d <= 256``, else ``ValueError``); a
    CPU tensor takes the plain version. ``tile_chains`` is ignored.
    """
    del tile_chains
    x, m, imm = _prepare(positions, momenta, inverse_mass_matrix, target)
    if x.device.type == "cuda":
        return _launch_cuda(x, m, imm, step_size, target=target, num_steps=num_steps)
    if x.device.type == "cpu":
        return _trajectory_plain(x, m, imm, step_size, target=target, num_steps=num_steps)
    raise NotImplementedError(f"no leapfrog for device type {x.device.type!r}")


def fused_leapfrog_plain(
    positions,
    momenta,
    inverse_mass_matrix,
    step_size,
    *,
    target: TargetKernel,
    num_steps: int,
    tile_chains: int = 256,
):
    """The plain PyTorch version of :func:`fused_leapfrog`, with the same
    arguments and outputs, on the device of ``positions``: on the card it is
    the kernel's reference. It launches nothing of ours and counts nothing."""
    del tile_chains
    x, m, imm = _prepare(positions, momenta, inverse_mass_matrix, target)
    return _trajectory_plain(x, m, imm, step_size, target=target, num_steps=num_steps)


# ---------------------------------------------------------------------------
# the HMC transition: one launch a fused_hmc step on the analytic targets
# ---------------------------------------------------------------------------


def _hmc_transition_ops(leapfrog, positions, logdensities, z, u, imm, step_size, *,
                        target, num_steps):
    """One ``fused_hmc`` transition from the draws ``z`` (``(C, d)`` standard
    normal momenta in the ``M^{1/2}`` basis) and ``u`` (``(C,)`` accept
    uniforms), term by term as the reference's step
    (``blackjax_tpu/ops/fused_hmc.py:82-110``), with the trajectory by
    ``leapfrog``. Returns the new positions and log densities, ``p_accept``,
    the accept flags and the proposal's energy."""
    momenta = z / torch.sqrt(imm)[None, :]
    kinetic0 = 0.5 * (momenta**2 * imm[None, :]).sum(1)
    energy0 = -logdensities + kinetic0

    x_new, m_new, energy1 = leapfrog(
        positions, momenta, imm, step_size, target=target, num_steps=num_steps)

    delta = energy0 - energy1
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    p_accept = torch.clamp(torch.exp(delta), max=1.0)
    accept = u < p_accept

    new_positions = torch.where(accept[:, None], x_new, positions)
    new_logdensities = torch.where(
        accept,
        # energy1 already holds -logdensity(x_end) + KE(m_end)
        -(energy1 - 0.5 * (m_new**2 * imm).sum(1)),
        logdensities,
    )
    return new_positions, new_logdensities, p_accept, accept, energy1


def _hmc_transition_plain(positions, logdensities, z, u, imm, step_size, *, target,
                          num_steps):
    """The plain version of the transition kernel: :func:`_hmc_transition_ops`
    over :func:`fused_leapfrog_plain`, on the device of ``positions``. It
    launches nothing of ours and counts nothing."""
    return _hmc_transition_ops(fused_leapfrog_plain, positions, logdensities, z, u, imm,
                               step_size, target=target, num_steps=num_steps)


def _hmc_transition_cuda(positions, logdensities, z, u, imm, step_size, *, target,
                         num_steps):
    """One launch of ``hmc_transition`` on the analytic ``target``, with the
    outputs of :func:`_hmc_transition_plain`."""
    C, d = positions.shape
    if d > _MAX_CUDA_DIM:
        raise ValueError(
            f"the CUDA HMC transition holds d <= {_MAX_CUDA_DIM} per warp; got d={d}")
    if target.matrix is not None:
        raise ValueError("the HMC transition kernel takes the analytic targets only")
    dev = positions.device
    for name, t, shape in [("positions", positions, (C, d)), ("logdensities", logdensities, (C,)),
                           ("z", z, (C, d)), ("u", u, (C,)), ("inverse_mass_matrix", imm, (d,))]:
        _nvcc.require_cuda_f32(name, t, dev, shape)
    inv_var = _inv_var(target, dev, d)
    lib = _library()
    out_x = torch.empty_like(positions)
    out_ld, p_accept, energy = (torch.empty(C, dtype=torch.float32, device=dev)
                                for _ in range(3))
    accept = torch.empty(C, dtype=torch.bool, device=dev)
    code = lib.bjt_hmc_transition(
        positions.data_ptr(), logdensities.data_ptr(), z.data_ptr(), u.data_ptr(),
        imm.data_ptr(), _ptr(inv_var), out_x.data_ptr(), out_ld.data_ptr(),
        p_accept.data_ptr(), accept.data_ptr(), energy.data_ptr(), C, d, num_steps,
        target.cuda_target, float(step_size), _nvcc.stream_handle(dev),
    )
    _nvcc.check_launch(lib, code, "hmc_transition")
    LAUNCHES["fused_leapfrog"] += 1
    LAUNCHES["fused_leapfrog:hmc_transition"] += 1
    return out_x, out_ld, p_accept, accept, energy
