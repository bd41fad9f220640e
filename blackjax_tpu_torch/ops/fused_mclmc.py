"""Fused multi-step MCLMC for registered analytic targets: one CUDA kernel
runs a whole unadjusted MCLMC trajectory per chain.

Port of ``blackjax_tpu/ops/fused_mclmc.py`` (``fused_mclmc`` and its Pallas
kernel ``_mclmc_kernel``). Two implementations of the same trajectory live
here:

- the CUDA kernel ``csrc/fused_mclmc.cu`` (one warp per chain), launched
  for CUDA tensors in one of three forms that :func:`plan` picks before the
  launch: the resident form on the hierarchical and Gaussian targets (all of
  the flagship's chains in one wave, the refresh noise drawn ahead into
  shared memory, the stages unrolled), the registers form where it is asked
  for (the same bits), and on logistic regression the tiles form of
  :mod:`~blackjax_tpu_torch.ops.fused_leapfrog` (the chains of a block share
  each gradient). :data:`LAUNCHES` counts each form;
- :func:`fused_mclmc_plain`, the plain PyTorch version on the ``(C, d)``
  block, taken for CPU tensors and used on the card as the kernel's
  reference.

Both keep the Pallas kernel's operation order (``fused_mclmc.py:130-198``)
and draw the refresh noise from the reference's counter-based normals
(:func:`~blackjax_tpu_torch.ops.counter_rng.counter_normals`, keyed on the
chain, the 128-padded lane, the seed and ``2 * step`` or ``2 * step + 1``),
so they round alike except for the order of their sums and the last ulp of
``log`` and ``cos`` in the noise. ``refresh=False`` (``L = inf``) makes the
dynamics deterministic.

Ported: the hierarchical, Gaussian and logistic-regression targets (those of
:mod:`~blackjax_tpu_torch.ops.fused_leapfrog`, through the device functions
the two kernels share), ``d <= 256`` on the card.
``tile_chains`` and ``interpret`` are accepted and ignored: chains are
independent on the GPU.
"""
import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from blackjax_tpu_torch.mcmc.integrators import mclachlan_coefficients
from blackjax_tpu_torch.ops import _nvcc, counter_rng
from blackjax_tpu_torch.ops.fused_leapfrog import (
    TargetKernel,
    _params_on,
    _ptr,
    _tiles_target_args,
)

__all__ = [
    "FORMS",
    "LAUNCHES",
    "build",
    "counter_normals_device",
    "fused_mclmc",
    "fused_mclmc_plain",
    "occupancy",
    "plan",
    "pool_layout",
    "pool_layout_device",
]

# kernel launches made by this module, by kernel name; a trajectory's launch
# also counts under its form
LAUNCHES = {"fused_mclmc": 0, "fused_mclmc:resident": 0, "fused_mclmc:registers": 0,
            "fused_mclmc:logreg_tiles": 0, "counter_normals": 0, "pool_layout": 0}

_LANE = 128  # the reference's lane padding, which the noise counters count
_MAX_CUDA_DIM = 256  # eight registers per lane and vector
_MAX_STAGES = 16
_ANALYTIC = (0, 1)  # the hierarchical and Gaussian targets' cuda_target
FORMS = ("resident", "registers")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _trajectory_plain(x, m, imm, step_size, L, *, target, num_steps, seed,
                      coefficients, track_dims, refresh):
    """``num_steps`` MCLMC steps on the f32 block in the Pallas kernel's
    order; returns positions, momenta, log densities and the history."""
    C, d = x.shape
    dev = x.device
    eps = torch.tensor(float(step_size), dtype=torch.float32, device=dev)
    sqrt_imm = torch.sqrt(imm)
    dims = float(d)
    d_pad = _round_up(d, _LANE)
    if refresh:
        L = torch.tensor(float(L), dtype=torch.float32, device=dev)
        nu = torch.sqrt((torch.exp(2.0 * (0.5 * eps) / L) - 1.0) / d)

    def row_norm(v):
        return torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))

    def kick(m, g, dt):
        gw = g * sqrt_imm
        grad_norm = row_norm(gw)
        e = gw / torch.clamp(grad_norm, min=1e-30)
        proj = torch.sum(m * e, dim=1, keepdim=True)
        delta = dt * grad_norm / (dims - 1.0)
        zeta = torch.exp(-delta)
        unnorm = e * ((1.0 - zeta) * (1.0 + zeta + proj * (1.0 - zeta))) + (2.0 * zeta) * m
        return unnorm / torch.clamp(row_norm(unnorm), min=1e-30)

    def ou_refresh(m, stream):
        noise = counter_rng.counter_normals(seed, 0, stream, (C, d_pad), device=dev)[:, :d]
        noisy = m + nu * noise
        return noisy / torch.clamp(row_norm(noisy), min=1e-30)

    track = torch.tensor(track_dims, dtype=torch.int64, device=dev)
    hist = torch.empty((C, num_steps, len(track_dims)), dtype=torch.float32, device=dev)
    g = target.grad_tile(x)
    for step in range(num_steps):
        if refresh:
            m = ou_refresh(m, 2 * step)
        for stage, coef in enumerate(coefficients):
            if stage % 2 == 0:
                m = kick(m, g, coef * eps)
            else:
                x = x + (coef * eps) * (m * sqrt_imm)
                g = target.grad_tile(x)
        if refresh:
            m = ou_refresh(m, 2 * step + 1)
        hist[:, step, :] = x[:, track]
    return x, m, target.logdensity_tile(x), hist


# ---------------------------------------------------------------------------
# the form's plan and the pool's layout
# ---------------------------------------------------------------------------


def plan(d: int, target: int, form: str = None) -> str:
    """The form of a launch on ``d`` dimensions of the target ``target`` (a
    ``cuda_target`` id): ``"resident"``, ``"registers"`` or ``"tiles"``.

    ``form=None`` takes the resident form on the hierarchical and Gaussian
    targets and the tiles form on logistic regression; ``"resident"`` and
    ``"registers"`` ask for one of the analytic targets' forms. A form that
    does not apply raises ``ValueError``; nothing falls back to another. The
    layout of each form (warps, the pool's steps, shared memory) is the
    kernel's own."""
    if form not in (None, *FORMS):
        raise ValueError(f"form must be None or one of {FORMS}, got {form!r}")
    if not 1 <= d <= _MAX_CUDA_DIM:
        raise ValueError(f"the CUDA MCLMC kernel holds d <= {_MAX_CUDA_DIM} per warp; got d={d}")
    if target not in _ANALYTIC:
        if form is not None:
            raise ValueError(f"logistic regression runs the tiles form; got form={form!r}")
        return "tiles"
    return form or "resident"


def pool_layout(d: int, steps: int):
    """The resident form's pooled draws of ``steps`` steps at width ``d``,
    as its warp draws them: an int64 ``(rounds, 32, 2)`` tensor whose
    ``[r, lane]`` is ``(q, j)`` of the normal that ``lane`` draws in round
    ``r`` (refresh ``q = 2 (step - the pool's first step) + (0 before the
    stages, 1 after)``, dim ``j``; its slot in the warp's pool is ``32 r +
    lane = q d + j``), or ``(-1, -1)`` where the lane idles in the last
    round. Each normal keeps the key of its step, refresh and dim."""
    count = 2 * steps * d
    slot = torch.arange(-(-count // 32) * 32, dtype=torch.int64)
    out = torch.stack([slot // d, slot % d], dim=-1)
    out[slot >= count] = -1
    return out.reshape(-1, 32, 2)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_U32 = ctypes.c_uint32
_FLOAT = ctypes.c_float


@functools.lru_cache(maxsize=1)
def _library():
    lib = _nvcc.load("fused_mclmc")
    lib.bjt_fused_mclmc.argtypes = (
        [_VP] * 11 + [ctypes.POINTER(_FLOAT)] + [_INT] * 9 + [_FLOAT] * 4 + [_U32, _VP]
    )
    lib.bjt_fused_mclmc.restype = _INT
    lib.bjt_fused_mclmc_occupancy.argtypes = [_INT] * 3 + [_VP]
    lib.bjt_fused_mclmc_occupancy.restype = _INT
    lib.bjt_mclmc_pool_layout.argtypes = [_INT, _INT, _VP, _VP]
    lib.bjt_mclmc_pool_layout.restype = _INT
    lib.bjt_counter_normals.argtypes = [_U32, _U32, _U32, _INT, _INT, _VP, _VP, _VP, _VP]
    lib.bjt_counter_normals.restype = _INT
    lib.bjt_error_string.argtypes = [_INT]
    lib.bjt_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (or load) the kernel library; returns the compiler's report of
    registers, shared memory and spills per kernel."""
    _library()
    return _nvcc.build_log("fused_mclmc")


def _launch_cuda(x, m, imm, step_size, L, *, target, num_steps, seed, coefficients,
                 track_dims, refresh, form=None):
    C, d = x.shape
    form = plan(d, target.cuda_target, form)
    dev = x.device
    for name, t, shape in [("positions", x, (C, d)), ("momenta", m, (C, d)),
                           ("inverse_mass_matrix", imm, (d,))]:
        _nvcc.require_cuda_f32(name, t, dev, shape)
    inv_var, matrix, rows, k = _tiles_target_args(target, dev, d)
    track = _params_on(track_dims, dev, torch.int32) if track_dims else None
    coefs = (_FLOAT * len(coefficients))(*coefficients)
    lib = _library()
    out_x, out_m = torch.empty_like(x), torch.empty_like(m)
    logdensity = torch.empty(C, dtype=torch.float32, device=dev)
    hist = torch.empty((C, num_steps, len(track_dims)), dtype=torch.float32, device=dev)
    code = lib.bjt_fused_mclmc(
        x.data_ptr(), m.data_ptr(), imm.data_ptr(), *map(_ptr, (inv_var, *matrix, track)),
        out_x.data_ptr(), out_m.data_ptr(), logdensity.data_ptr(),
        hist.data_ptr() if hist.numel() else None, coefs,
        len(coefficients), C, d, num_steps, len(track_dims), target.cuda_target, rows,
        int(refresh), int(form == "resident"), float(step_size),
        float(L) if refresh else math.inf, *k, seed & counter_rng.MASK32,
        _nvcc.stream_handle(dev),
    )
    _nvcc.check_launch(lib, code, "fused_mclmc")
    LAUNCHES["fused_mclmc"] += 1
    LAUNCHES["fused_mclmc:logreg_tiles" if form == "tiles" else f"fused_mclmc:{form}"] += 1
    return out_x, out_m, logdensity, hist


def occupancy(d: int, form: str = "resident", target: int = 0) -> dict:
    """What the card reports for the analytic target's instantiation for
    ``d`` in the resident form (McLachlan's stages) or the registers form:
    its resident warps an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    its registers and local memory a thread in bytes, and the resident
    form's steps a pool (0 in the registers form). Needs the card."""
    out = (_INT * 4)()
    lib = _library()
    code = lib.bjt_fused_mclmc_occupancy(d, target, int(plan(d, target, form) == "resident"),
                                         out)
    _nvcc.check_launch(lib, code, "bjt_fused_mclmc_occupancy")
    return {"warps_per_sm": out[0], "registers": out[1], "local_bytes": out[2],
            "pool_steps": out[3]}


def pool_layout_device(d: int, steps: int, device):
    """:func:`pool_layout` through the kernel's own walk on a CUDA
    ``device``."""
    device = torch.device(device)
    rounds = -(-2 * steps * d // 32)
    out = torch.empty((rounds, 32, 2), dtype=torch.int32, device=device)
    lib = _library()
    code = lib.bjt_mclmc_pool_layout(d, steps, out.data_ptr(), _nvcc.stream_handle(device))
    _nvcc.check_launch(lib, code, "pool_layout")
    LAUNCHES["pool_layout"] += 1
    return out.to(torch.int64)


def _prepare(positions, momenta, inverse_mass_matrix, target, coefficients, track_dims):
    C, d = positions.shape
    if d != target.dim:
        raise ValueError(f"positions dim {d} != registered target dim {target.dim}")
    if tuple(momenta.shape) != (C, d):
        raise ValueError(f"momenta {tuple(momenta.shape)} != positions {(C, d)}")
    coefficients = tuple(float(c) for c in (
        mclachlan_coefficients if coefficients is None else coefficients))
    if not 1 <= len(coefficients) <= _MAX_STAGES or len(coefficients) % 2 == 0:
        raise ValueError(
            f"a palindromic scheme has an odd number of stages, at most {_MAX_STAGES}; "
            f"got {len(coefficients)}"
        )
    track_dims = tuple(int(j) for j in track_dims)
    if any(not 0 <= j < d for j in track_dims):
        raise ValueError(f"tracked dims {track_dims} outside [0, {d})")
    dev = positions.device
    x = positions.to(torch.float32).contiguous()
    m = momenta.to(device=dev, dtype=torch.float32).contiguous()
    imm = torch.as_tensor(inverse_mass_matrix).to(device=dev, dtype=torch.float32)
    return x, m, torch.broadcast_to(imm, (d,)).contiguous(), coefficients, track_dims


def fused_mclmc(
    positions,
    momenta,
    inverse_mass_matrix,
    step_size,
    L,
    *,
    target: TargetKernel,
    num_steps: int,
    seed: int = 0,
    coefficients: Optional[Sequence[float]] = None,
    track_dims: Sequence[int] = (),
    tile_chains: int = 256,
    refresh: bool = True,
    interpret: bool = False,
    form: str = None,
):
    """Run ``num_steps`` stochastic isokinetic (MCLMC) steps per chain.

    ``positions`` and ``momenta`` are ``(C, d)`` (momenta unit-norm rows),
    ``inverse_mass_matrix`` a ``(d,)`` diagonal (or a scalar); ``step_size``
    and ``L`` are numbers. Returns ``(positions, momenta, logdensities,
    history)`` as f32, with ``history`` of shape ``(C, num_steps,
    len(track_dims))``: the tracked coordinates after every step.

    ``coefficients`` is a palindromic scheme (McLachlan's by default; at
    most 16 stages). ``refresh=False`` drops the O-U refresh (the ``L = inf``
    limit): deterministic dynamics. The noise is keyed on ``(seed, chain,
    step, phase)``, as the reference keys it.

    A CUDA tensor launches the kernel (``d <= 256``, else ``ValueError``)
    in the form :func:`plan` picks, or in ``form`` (``"resident"`` or
    ``"registers"``) where it is given; a form that does not apply raises,
    on any device. A CPU tensor takes the plain version. ``tile_chains`` and
    ``interpret`` are ignored.
    """
    del tile_chains, interpret
    x, m, imm, coefficients, track_dims = _prepare(
        positions, momenta, inverse_mass_matrix, target, coefficients, track_dims)
    if form is not None:
        plan(x.shape[1], target.cuda_target, form)
    kw = dict(target=target, num_steps=num_steps, seed=seed, coefficients=coefficients,
              track_dims=track_dims, refresh=refresh)
    if x.device.type == "cuda":
        return _launch_cuda(x, m, imm, step_size, L, form=form, **kw)
    if x.device.type == "cpu":
        return _trajectory_plain(x, m, imm, step_size, L, **kw)
    raise NotImplementedError(f"no MCLMC kernel for device type {x.device.type!r}")


def fused_mclmc_plain(
    positions,
    momenta,
    inverse_mass_matrix,
    step_size,
    L,
    *,
    target: TargetKernel,
    num_steps: int,
    seed: int = 0,
    coefficients: Optional[Sequence[float]] = None,
    track_dims: Sequence[int] = (),
    tile_chains: int = 256,
    refresh: bool = True,
    interpret: bool = False,
):
    """The plain PyTorch version of :func:`fused_mclmc`, with the same
    arguments and outputs, on the device of ``positions``: on the card it is
    the kernel's reference. It launches nothing of ours and counts nothing."""
    del tile_chains, interpret
    x, m, imm, coefficients, track_dims = _prepare(
        positions, momenta, inverse_mass_matrix, target, coefficients, track_dims)
    return _trajectory_plain(
        x, m, imm, step_size, L, target=target, num_steps=num_steps, seed=seed,
        coefficients=coefficients, track_dims=track_dims, refresh=refresh,
    )


def counter_normals_device(seed: int, chain_base: int, stream: int, rows: int, d: int,
                           device):
    """The refresh noise of chains ``chain_base .. chain_base + rows - 1``
    at one ``stream``: the threefry words (int64 in ``[0, 2**32)``) and the
    f32 normals, each ``(rows, d)``, through the kernel's own device
    functions on a CUDA ``device``, or the plain version on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        shape = (rows, _round_up(d, _LANE))
        b1, b2 = counter_rng.counter_normal_words(seed, chain_base, stream, shape, device=device)
        b1, b2 = b1[:, :d], b2[:, :d]
        return b1, b2, counter_rng.box_muller(b1, b2)
    w0 = torch.empty((rows, d), dtype=torch.int32, device=device)
    w1 = torch.empty_like(w0)
    z = torch.empty((rows, d), dtype=torch.float32, device=device)
    lib = _library()
    mask = counter_rng.MASK32
    code = lib.bjt_counter_normals(
        seed & mask, chain_base & mask, stream & mask, rows, d,
        w0.data_ptr(), w1.data_ptr(), z.data_ptr(), _nvcc.stream_handle(device),
    )
    _nvcc.check_launch(lib, code, "counter_normals")
    LAUNCHES["counter_normals"] += 1
    return w0.to(torch.int64) & mask, w1.to(torch.int64) & mask, z
