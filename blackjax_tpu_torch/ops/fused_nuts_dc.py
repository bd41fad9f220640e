"""The continuous NUTS machine: ``num_steps`` transitions per chain in one
CUDA kernel.

Port of ``blackjax_tpu/ops/fused_nuts_dc.py`` (``fused_nuts_run_dc`` and its
Pallas kernel ``_nuts_kernel_dc``). The machine is the flattened NUTS engine
taken one leapfrog leaf per iteration (``mcmc/trajectory.py``), with the
inline restart of the continuous runner: a chain that closes a transition
starts its next one on the following iteration. Its randomness is the
counter-based threefry of :mod:`blackjax_tpu_torch.ops.counter_rng`, keyed
on (seed, chain, step, depth or leaf, stream) exactly as the Pallas kernel
keys it, so the port draws the same numbers as the reference and can be held
against it chain by chain.

Two implementations of the same machine live here:

- the CUDA kernel ``csrc/fused_nuts_dc.cuh`` (one warp per chain), launched
  for CUDA tensors;
- :func:`fused_nuts_run_dc_plain`, the plain PyTorch version on a ``(C, d)``
  batch with masks, taken for CPU tensors and used on the card as the
  kernel's reference.

Ported: the diagonal, dense ``(d, d)`` and low-rank
(:class:`~blackjax_tpu_torch.mcmc.metrics.LowRankInverseMassMatrix`)
metrics; the hierarchical and Gaussian targets, and the matrix targets of
:mod:`blackjax_tpu_torch.ops.targets_dc` (logistic regression, the Finnish
horseshoe, eight schools). On the card the diagonal metric takes ``d <=
512``, the dense and low-rank metrics ``d <= 256``. The dense and low-rank
machines carry the ``w = M^{-1} m`` companion of the trajectory's two
endpoints and of every checkpoint slot, as the reference does, so that the
U-turn checks and the energy stay dot products. The reference's
``FNUTS_DISABLE`` attribution switch is left out, and nothing is padded: the
port works on exact ``d`` and exact rank ``k``.

``pack`` and ``restart_every`` schedule the TPU's lockstep lanes. The GPU
runs every chain on its own warp, so neither changes a chain's draws or
path; they matter only where the leaf ``budget`` binds, because the
reference counts the budget per lane of ``pack`` chains run one after the
other, and a gated restart parks a chain for up to ``restart_every - 1``
leaves. The port reproduces that accounting exactly (see
:func:`_lane_budgets`): each chain gets a budget of its own and a local
clock on which restarts are gated, so ``steps[c] < num_steps`` flags the
chains the reference flags. ``tile_chains`` enters only that accounting.

On the card the analytic targets take the resident form up to ``d = 256``
(the dense metric from ``d = 225``): one warp a chain, as many warps an SM
as :func:`resident_warps` says, the leaf's vectors in registers and the rest
of the chain's state in device memory, its checkpoint slots in shared memory
where they fit; the dense metric below ``d = 225`` and every ``d > 256``
keep the whole state in registers (``csrc/fused_nuts_dc.cuh``). Eight
schools (``d = 10``) under the diagonal metric has a thread form besides:
one chain a thread, 32 a warp, its sums trees of adds in one thread in the
registers form's association order, so both give the same bits; it runs
where ``_EIGHT_SCHOOLS_THREAD`` is set (by default not: it measured
slower), and eight schools otherwise keeps the registers form. The Finnish
horseshoe's data matrix is copied into shared
memory once per block where it fits beside the block's four chains, and read
from L2 where it does not. Logistic regression always takes the tiles form:
the chains of a block run their leaves in lockstep and share one gradient,
which streams X through shared memory in tiles, once per leaf for the whole
block (``csrc/matrix_targets.cuh``: ``logreg_tiles``); a dense or low-rank
metric's matrices are copied into shared memory where they fit beside it.
:func:`shared_memory_plan` counts the bytes and picks the form before the
launch, and :data:`LAUNCHES` counts each form. A block runs to its slowest
chain: :func:`lockstep_idle_share` says how many of its warps' iterations
were spent waiting.

The same source exports the kernel's threefry2x32 with a key per element
(:func:`threefry2x32_device`, through which :mod:`blackjax_tpu_torch.prng`
draws on the card), beside its plain version.
"""
import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix
from blackjax_tpu_torch.ops import _nvcc
from blackjax_tpu_torch.ops.counter_rng import (
    counter_uniforms,
    counter_uniforms2,
    momentum_normals,
    popcount8,
    threefry2x32,
)

__all__ = [
    "TargetKernelDC",
    "DCMetric",
    "LAUNCHES",
    "MatrixTargetData",
    "SharedMemoryPlan",
    "build",
    "fused_nuts_run_dc",
    "lockstep_idle_share",
    "fused_nuts_run_dc_plain",
    "occupancy",
    "resident_warps",
    "scratch_floats",
    "make_gaussian_target_dc",
    "make_hierarchical_target_dc",
    "shared_memory_plan",
    "threefry2x32_device",
    "RESIDENT_WIDTHS",
]

# kernel launches made by the wrappers below, by kernel name; a run that
# should go through a kernel resets the count and reads it afterwards. A
# launch of the dc machine on a target with a data matrix X also counts under
# the form it took: X copied into shared memory, read from L2, or streamed in
# tiles by chains in lockstep (logistic regression); one on an analytic
# target under its form: resident (the chain's state and slots in device
# memory, all chains of a launch resident at once) or registers; one on eight
# schools under its form: thread (one chain a thread) or registers (one
# chain a warp).
LAUNCHES = {"fused_nuts_dc": 0, "fused_nuts_dc:x_shared": 0, "fused_nuts_dc:x_l2": 0,
            "fused_nuts_dc:x_tiles": 0, "fused_nuts_dc:analytic_resident": 0,
            "fused_nuts_dc:analytic_registers": 0, "fused_nuts_dc:thread": 0,
            "fused_nuts_dc:registers": 0, "threefry2x32": 0, "normal": 0}

# the target ids of csrc/fused_nuts_dc.cu and csrc/matrix_targets.cuh
_CUDA_HIERARCHICAL = 0
_CUDA_GAUSSIAN = 1
_CUDA_LOGREG = 2
_CUDA_HORSESHOE = 3
_CUDA_EIGHT_SCHOOLS = 4
_MAX_CUDA_DIM = 512  # sixteen registers per lane and vector
_MAX_CUDA_DIM_METRIC = 256  # dense and low-rank: eight (ROADMAP queue 2, item 2f)
_MAX_SCALARS = 8
_REGISTER_WIDTHS = (1, 2, 4, 8, 13, 16)  # the instantiations' N
_WARPS = 4  # chains per block (kWarps)
_RESIDENT_BLOCK_WARPS = 1  # chains per block of the resident form (kResidentBlockWarps)
_CHAINS_LR = 8  # chains per block of the tiles form (kChainsLR)
# the analytic targets' resident form, by metric: the widths (N) that take
# it, where it measured faster (dc_kernel_ms.py: PERF.md §6); the others keep
# one warp's state in registers
RESIDENT_WIDTHS = {"diag": (1, 2, 4, 8), "dense": (8,), "low_rank": (1, 2, 4, 8)}
# whether eight schools under the diagonal metric takes the thread form (one
# chain a thread, csrc/fused_nuts_dc.cuh:nuts_dc_thread); the dense and
# low-rank metrics keep the registers form. Off: at the tracked shape it
# measured 2.16 times slower than the registers form (dc_kernel_ms.py
# --target eight_schools: PERF.md §6), so it runs only where a caller sets this
_EIGHT_SCHOOLS_THREAD = False
_THREAD_DIM = 10  # eight schools (kThreadDim)
_THREAD_VECTORS = 8  # the proposal (x, g) and both ends (x, m, g) (kThreadVectors)
SHARED_MEMORY_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
_SMEM_PER_SM = 233_472  # bytes of shared memory an SM shares among its blocks (kSmemPerSM)
_SMEM_RESERVED = 1_024  # bytes each block of them reserves (kSmemReserved)
# the library of each metric's instantiations of csrc/fused_nuts_dc.cuh
_LIBRARIES = {"diag": "fused_nuts_dc", "dense": "fused_nuts_dc_dense",
              "low_rank": "fused_nuts_dc_low_rank"}


class DCMetric(NamedTuple):
    """The machine's metric operands, as the reference builds them
    (``fused_nuts_dc.py:837-893``), all f32 on the positions' device:

    - ``"diag"``: ``(imm (d,), sigma_m (d,))``, ``sigma_m = sqrt(1 / imm)``
      and 0 where ``imm <= 0``;
    - ``"dense"``: ``(imm (d, d), chol_mass (d, d))`` with ``chol_mass
      chol_mass^T = M``;
    - ``"low_rank"``: ``(sigma (d,), 1 / sigma, U (d, k), lam - 1,
      1 / sqrt(lam) - 1)``.
    """

    kind: str
    ops: tuple


_XOR_LANES = {o: [lane ^ o for lane in range(32)] for o in (16, 8, 4, 2, 1)}


def _warp_sum(a):
    """The sum over the last axis in the kernel's order: lane ``j`` adds dims
    ``j, j + 32, ...`` one after the other, then an xor butterfly over the
    32 lanes (``warp_sum``), so that both round alike."""
    d = a.shape[-1]
    n = -(-d // 32)
    a = torch.nn.functional.pad(a, (0, n * 32 - d)).reshape(*a.shape[:-1], n, 32)
    s = a[..., 0, :]
    for k in range(1, n):
        s = s + a[..., k, :]
    for lanes in _XOR_LANES.values():
        s = s + s[..., lanes]
    return s[..., 0]


def _metric_fns(metric: DCMetric):
    """``(imm_mv, sample_m)`` on a ``(C, d)`` batch: ``M^{-1} m`` and the
    momentum ``M^{1/2} z`` from standard normals, in the reference's
    operation order. The dense and low-rank products also sum in the CUDA
    kernel's order (``csrc/fused_nuts_dc.cuh``: ``dense_mv``, ``low_rank_mv``),
    so that on the card the plain version rounds as the kernel does."""
    if metric.kind == "diag":
        imm, sigma_m = metric.ops
        return (lambda m: imm * m), (lambda z: sigma_m * z)
    if metric.kind == "dense":
        imm_t, chol_t = (a.T.contiguous() for a in metric.ops)

        def dense_mv(a_t, v):  # A v = sum_i A^T[i] v_i, over i in order
            acc = torch.zeros_like(v)
            for i in range(v.shape[-1]):
                acc = acc + a_t[i] * v[:, i, None]
            return acc

        return (lambda m: dense_mv(imm_t, m)), (lambda z: dense_mv(chol_t, z))
    sigma, inv_sigma, U, lam_m1, isl_m1 = metric.ops

    def lrmv(y, s_m1):  # (I + U diag(s_m1) U^T) y, over the rank in order
        st = s_m1 * _warp_sum(y[:, None, :] * U.T)
        acc = torch.zeros_like(y)
        for j in range(U.shape[1]):
            acc = acc + st[:, j, None] * U[:, j]
        return y + acc

    # M^{-1} = D (I + U (Lam - 1) U^T) D; M^{1/2} = D^{-1} (I + U (Lam^{-1/2} - 1) U^T)
    return (lambda m: sigma * lrmv(sigma * m, lam_m1)), (lambda z: inv_sigma * lrmv(z, isl_m1))


class MatrixTargetData(NamedTuple):
    """What a matrix target's device function reads: the data matrix ``X``
    (``(rows, cols)`` f32, row-major; the wrapper uploads it and its
    transpose), two host vectors and up to eight scalars, each as
    ``csrc/matrix_targets.cuh`` documents it for the target."""

    X: Optional[np.ndarray]
    u: np.ndarray
    s: Optional[np.ndarray]
    scalars: tuple


def _on_device(*arrays):
    """``get(x)``: the host arrays as tensors in ``x``'s dtype and on its
    device, copied once per (device, dtype)."""
    cache = {}

    def get(x):
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = tuple(torch.from_numpy(a).to(device=x.device, dtype=x.dtype)
                               for a in arrays)
        return cache[key]

    return get


@dataclass(frozen=True, eq=False)
class TargetKernelDC:
    """A target of the machine.

    ``value_and_grad(x) -> (logdensity (C,), grad (C, d))`` is the plain
    PyTorch version on an f32 ``(C, d)`` batch; ``cuda_target`` names the
    same target's device function in ``csrc/fused_nuts_dc.cu``; ``params``
    are its host values as in the reference's ``TargetKernelDC`` (the
    Gaussian's inverse variances, a matrix target's folded vectors and
    padded data); ``matrix`` is what a matrix target's device function
    reads.
    """

    name: str
    dim: int
    value_and_grad: Callable
    logdensity_fn: Callable
    cuda_target: int
    params: tuple = ()
    matrix: Optional[MatrixTargetData] = None


def make_gaussian_target_dc(dim: int, variances=None) -> TargetKernelDC:
    """Independent Gaussian ``N(0, diag(variances))``."""
    if variances is None:
        inv_var_host = torch.ones(dim, dtype=torch.float32)
    else:
        inv_var_host = 1.0 / torch.as_tensor(variances, dtype=torch.float32)
    return gaussian_target_dc_from_params(dim, tuple(float(v) for v in inv_var_host))


def gaussian_target_dc_from_params(dim: int, inv_var_param: tuple) -> TargetKernelDC:
    """The Gaussian target from its inverse variances, as the reference's
    ``make_gaussian_target_dc(...).params[0]`` holds them."""
    if len(inv_var_param) != dim:
        raise ValueError(f"{len(inv_var_param)} inverse variances for dim {dim}")

    def value_and_grad(x):
        inv_var = torch.tensor(inv_var_param, dtype=x.dtype, device=x.device)
        ld = -0.5 * (x * x * inv_var).sum(-1)
        return ld, -x * inv_var

    def logdensity_fn(x):
        inv_var = torch.tensor(inv_var_param, dtype=x.dtype, device=x.device)
        return -0.5 * (x**2 * inv_var).sum(-1)

    return TargetKernelDC(
        name="gaussian_dc",
        dim=dim,
        value_and_grad=value_and_grad,
        logdensity_fn=logdensity_fn,
        cuda_target=_CUDA_GAUSSIAN,
        params=(inv_var_param,),
    )


def make_hierarchical_target_dc(dim: int) -> TargetKernelDC:
    """The flagship hierarchical Gaussian ``x = (log_tau, theta)``, written in
    the reference's operation order so both round alike."""
    n_theta = dim - 1

    def value_and_grad(x):
        log_tau = x[:, 0]
        theta = x[:, 1:]
        theta_sq = (theta * theta).sum(-1)
        exp_neg = torch.exp(-log_tau)
        ld = (
            -0.5 * log_tau**2
            - 0.5 * theta_sq * exp_neg
            - 0.5 * n_theta * log_tau
        )
        g_tau = -log_tau + 0.5 * theta_sq * exp_neg - 0.5 * n_theta
        grad = torch.cat([g_tau[:, None], -(theta * exp_neg[:, None])], dim=1)
        return ld, grad

    def logdensity_fn(x):
        log_tau = x[..., 0]
        theta = x[..., 1:]
        return (
            -0.5 * log_tau**2
            - 0.5 * (theta**2).sum(-1) * torch.exp(-log_tau)
            - 0.5 * n_theta * log_tau
        )

    return TargetKernelDC(
        name="hierarchical_gaussian_dc",
        dim=dim,
        value_and_grad=value_and_grad,
        logdensity_fn=logdensity_fn,
        cuda_target=_CUDA_HIERARCHICAL,
    )


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a * b).sum(-1)


def _logaddexp(a, b):
    """JAX's spelling: a NaN difference (equal infinities) gives ``a + b``,
    so ``logaddexp(-inf, -inf) == -inf`` where the naive form gives NaN."""
    delta = a - b
    return torch.where(
        torch.isnan(delta),
        a + b,
        torch.maximum(a, b) + torch.log1p(torch.exp(-delta.abs())),
    )


def _sel(pred, on_true, on_false):
    if on_true.dim() > pred.dim():
        pred = pred[:, None]
    return torch.where(pred, on_true, on_false)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _machine_plain(
    x0,
    metric: DCMetric,
    step_size: float,
    *,
    target: TargetKernelDC,
    num_steps: int,
    max_depth: int,
    seed: int,
    track_rows: tuple,
    budget: int,
    chunk: int,
    divergence_threshold: float,
    restart_every: int = 1,
    budgets=None,
):
    """The machine on a ``(C, d)`` f32 batch in plain PyTorch, with masks.

    Mirrors ``_nuts_kernel_dc`` select for select, carrying the ``w = M^{-1}
    m`` companions of the endpoints and checkpoint slots for every metric
    (for the diagonal one they equal the reference's ``imm * m``, which it
    recomputes instead, bit for bit). Chain ``c`` runs at most
    ``budgets[c]`` leaf iterations (``budget`` for every chain when
    ``budgets`` is None); a chain that closed a transition restarts only on
    iterations that are multiples of ``restart_every`` and is parked until
    then. The leaf loop stops early once every chain is finished, checked
    once per ``chunk`` iterations (one host sync per chunk). Returns
    ``(acc_x (C, d), steps (C,) int32, grads (C,) f32, history (C, S, k),
    iters (C,) int32)``, where ``iters`` counts the iterations a chain used
    up to its last closed transition.
    """
    C, d = x0.shape
    S = num_steps
    dev = x0.device
    vg = target.value_and_grad
    imm_mv, sample_m = _metric_fns(metric)
    f32 = torch.float32
    eps = torch.tensor(step_size, dtype=f32, device=dev)
    chain = torch.arange(C, dtype=torch.int64, device=dev)
    track = torch.tensor(track_rows, dtype=torch.int64, device=dev)
    if budgets is None:
        budgets = torch.full((C,), budget, dtype=torch.int64, device=dev)
    budgets = budgets.to(device=dev, dtype=torch.int64)

    acc_x = x0
    acc_ld, acc_g = vg(acc_x)
    zero_v = torch.zeros_like(x0)
    zero_s = torch.zeros(C, dtype=f32, device=dev)
    zero_i = torch.zeros(C, dtype=torch.int64, device=dev)
    fbool = torch.zeros(C, dtype=torch.bool, device=dev)
    neg_inf = torch.full((C,), -torch.inf, dtype=f32, device=dev)
    s = dict(
        acc_x=acc_x, acc_g=acc_g, acc_ld=acc_ld,
        steps=zero_i,
        done=~fbool,  # iteration 0 starts with done = 1
        cur_x=x0, cur_m=zero_v, cur_g=acc_g,
        left_x=x0, left_m=zero_v, left_g=acc_g, left_w=zero_v,
        right_x=x0, right_m=zero_v, right_g=acc_g, right_w=zero_v,
        msum=zero_v, sub_msum=zero_v,
        prop_x=x0, prop_g=acc_g, prop_ld=acc_ld,
        prop_w=zero_s, prop_slpa=zero_s,
        sub_x=x0, sub_g=acc_g, sub_ld=acc_ld,
        sub_w=zero_s, sub_slpa=zero_s,
        h0=zero_s,
        direction=zero_s + 1.0,
        depth=zero_i, leaf=zero_i, nstates=zero_i,
        div=fbool, turn=fbool,
        grads=zero_s,
        iters=zero_i,
        ckpt_m=[zero_v] * max_depth,
        ckpt_s=[zero_v] * max_depth,
        ckpt_w=[zero_v] * max_depth,
    )
    hist = torch.zeros(C, S, len(track_rows), dtype=f32, device=dev)

    def leaf_step(s, it):
        live = (s["steps"] < S) & (it < budgets)
        base_row = chain * S + s["steps"]  # per-(chain, step) counter key

        # ---- inline restart: chains that closed start the next one, on
        # the gated iterations only (the others leave them parked) ----
        start = s["done"] & live & (it % restart_every == 0)
        fresh_m = sample_m(momentum_normals(seed, base_row, d))
        w_fresh = imm_mv(fresh_m)
        h0_new = -s["acc_ld"] + 0.5 * _dot(w_fresh, fresh_m)
        for name, fresh in [
            ("cur_x", s["acc_x"]), ("cur_m", fresh_m), ("cur_g", s["acc_g"]),
            ("left_x", s["acc_x"]), ("left_m", fresh_m), ("left_g", s["acc_g"]),
            ("left_w", w_fresh),
            ("right_x", s["acc_x"]), ("right_m", fresh_m), ("right_g", s["acc_g"]),
            ("right_w", w_fresh),
            ("msum", fresh_m), ("sub_msum", zero_v),
            ("prop_x", s["acc_x"]), ("prop_g", s["acc_g"]), ("prop_ld", s["acc_ld"]),
            ("sub_x", s["acc_x"]), ("sub_g", s["acc_g"]), ("sub_ld", s["acc_ld"]),
            ("prop_w", zero_s), ("prop_slpa", neg_inf),
            ("sub_w", zero_s), ("sub_slpa", neg_inf),
            ("h0", h0_new),
            ("depth", zero_i), ("leaf", zero_i), ("nstates", zero_i),
        ]:
            s[name] = _sel(start, fresh, s[name])
        s["div"] = s["div"] & ~start
        s["turn"] = s["turn"] & ~start
        s["done"] = s["done"] & ~start
        active = ~s["done"] & live

        # ---- subtree start: direction draw ----
        at_start = (s["leaf"] == 0) & active
        u_dir, u_prop = counter_uniforms2(seed, base_row, 2, s["depth"])
        one = torch.ones_like(u_dir)
        new_dir = torch.where(u_dir < 0.5, -one, one)
        direction = torch.where(at_start, new_dir, s["direction"])
        fwd = direction > 0.0
        cur_x = _sel(at_start, _sel(fwd, s["right_x"], s["left_x"]), s["cur_x"])
        cur_m = _sel(at_start, _sel(fwd, s["right_m"], s["left_m"]), s["cur_m"])
        cur_g = _sel(at_start, _sel(fwd, s["right_g"], s["left_g"]), s["cur_g"])

        # ---- one velocity-Verlet leaf ----
        d_eps = (direction * eps)[:, None]
        m_half = cur_m + 0.5 * d_eps * cur_g
        new_x = cur_x + d_eps * imm_mv(m_half)
        new_ld, new_g = vg(new_x)
        new_m = m_half + 0.5 * d_eps * new_g
        w_new = imm_mv(new_m)
        energy = -new_ld + 0.5 * _dot(w_new, new_m)
        delta = s["h0"] - energy
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        leaf_w = delta
        leaf_slpa = torch.minimum(delta, torch.zeros_like(delta))
        leaf_div = (-delta > divergence_threshold) & active

        # ---- progressive uniform merge within the subtree ----
        u_leaf = counter_uniforms(seed, base_row, 3, s["nstates"])
        p_acc = torch.sigmoid(leaf_w - s["sub_w"])
        take = (u_leaf < p_acc) & active
        sub_x = _sel(at_start, new_x, _sel(take, new_x, s["sub_x"]))
        sub_g = _sel(at_start, new_g, _sel(take, new_g, s["sub_g"]))
        sub_ld = _sel(at_start, new_ld, _sel(take, new_ld, s["sub_ld"]))
        sub_w = _sel(at_start, leaf_w, _logaddexp(s["sub_w"], leaf_w))
        sub_slpa = _sel(at_start, leaf_slpa, _logaddexp(s["sub_slpa"], leaf_slpa))
        sub_msum = _sel(at_start, new_m, s["sub_msum"] + new_m)

        # ---- checkpointed subtree U-turn ----
        leaf_i = s["leaf"]
        idx_max = popcount8(leaf_i >> 1)
        idx_min = idx_max - popcount8(((~leaf_i) & (leaf_i + 1)) - 1) + 1
        is_even = (leaf_i % 2) == 0
        rho_base = sub_msum - 0.5 * new_m
        subtree_turning = fbool
        ckpt_m, ckpt_s, ckpt_w = [], [], []
        for i in range(max_depth):
            w_i = is_even & (idx_max == i) & active
            ckm = _sel(w_i, new_m, s["ckpt_m"][i])
            cks = _sel(w_i, sub_msum, s["ckpt_s"][i])
            ckw = _sel(w_i, w_new, s["ckpt_w"][i])  # the slot's M^{-1} m
            chk = (i >= idx_min) & (i <= idx_max) & ~is_even
            rho = rho_base - cks + 0.5 * ckm
            slot_turn = (_dot(ckw, rho) <= 0.0) | (_dot(w_new, rho) <= 0.0)
            subtree_turning = subtree_turning | (chk & slot_turn)
            ckpt_m.append(ckm)
            ckpt_s.append(cks)
            ckpt_w.append(ckw)
        subtree_turning = subtree_turning & active

        # ---- subtree boundary ----
        leaf_next = leaf_i + 1
        subtree_complete = leaf_next >= (torch.ones_like(leaf_i) << s["depth"])
        aborted = leaf_div | subtree_turning
        closing = (subtree_complete | aborted) & active
        msum = _sel(closing, s["msum"] + sub_msum, s["msum"])
        to_left, to_right = closing & ~fwd, closing & fwd
        left_x = _sel(to_left, new_x, s["left_x"])
        left_m = _sel(to_left, new_m, s["left_m"])
        left_g = _sel(to_left, new_g, s["left_g"])
        left_w = _sel(to_left, w_new, s["left_w"])
        right_x = _sel(to_right, new_x, s["right_x"])
        right_m = _sel(to_right, new_m, s["right_m"])
        right_g = _sel(to_right, new_g, s["right_g"])
        right_w = _sel(to_right, w_new, s["right_w"])

        # biased merge toward the new subtree; an aborted subtree adds its
        # acceptance statistics only
        p_biased = torch.minimum(torch.exp(sub_w - s["prop_w"]), torch.ones_like(sub_w))
        take_traj = (u_prop < p_biased) & closing & ~aborted
        prop_x = _sel(take_traj, sub_x, s["prop_x"])
        prop_g = _sel(take_traj, sub_g, s["prop_g"])
        prop_ld = _sel(take_traj, sub_ld, s["prop_ld"])
        merged_pw = _logaddexp(s["prop_w"], sub_w)
        prop_w = _sel(closing & ~aborted, merged_pw, s["prop_w"])
        prop_slpa = _sel(closing, _logaddexp(s["prop_slpa"], sub_slpa), s["prop_slpa"])

        rho = msum - 0.5 * (left_m + right_m)
        full_turn = closing & ((_dot(left_w, rho) <= 0.0) | (_dot(right_w, rho) <= 0.0))
        depth = torch.where(closing, s["depth"] + 1, s["depth"])
        leaf = torch.where(closing, zero_i, leaf_next)
        div = s["div"] | leaf_div
        turn = s["turn"] | (closing & (subtree_turning | full_turn))
        done_new = div | turn | (closing & (depth >= max_depth))
        nstates = torch.where(active, s["nstates"] + 1, s["nstates"])

        # ---- transition close: accept, count, record ----
        just_closed = active & done_new
        grads = s["grads"] + torch.where(just_closed, nstates.to(f32), 0.0)
        acc_x = _sel(just_closed, prop_x, s["acc_x"])
        row = s["steps"].clamp(max=S - 1)  # history row of the closing step
        hist[chain, row] = _sel(just_closed, acc_x[:, track], hist[chain, row])
        steps = torch.where(just_closed, s["steps"] + 1, s["steps"])
        s["iters"] = torch.where(just_closed, it + 1, s["iters"])

        s.update(
            cur_x=new_x, cur_m=new_m, cur_g=new_g,
            left_x=left_x, left_m=left_m, left_g=left_g, left_w=left_w,
            right_x=right_x, right_m=right_m, right_g=right_g, right_w=right_w,
            msum=msum, sub_msum=sub_msum,
            prop_x=prop_x, prop_g=prop_g, prop_ld=prop_ld,
            prop_w=prop_w, prop_slpa=prop_slpa,
            sub_x=sub_x, sub_g=sub_g, sub_ld=sub_ld,
            sub_w=sub_w, sub_slpa=sub_slpa,
            direction=direction, depth=depth, leaf=leaf, nstates=nstates,
            div=div, turn=turn, done=done_new | s["done"],
            grads=grads, steps=steps, acc_x=acc_x,
            acc_g=_sel(just_closed, prop_g, s["acc_g"]),
            acc_ld=_sel(just_closed, prop_ld, s["acc_ld"]),
            ckpt_m=ckpt_m, ckpt_s=ckpt_s, ckpt_w=ckpt_w,
        )

    for c0 in range(0, int(budgets.max()) if C else 0, chunk):
        if bool(((s["steps"] >= S) | (budgets <= c0)).all()):
            break
        for it in range(c0, c0 + chunk):
            leaf_step(s, it)
    i32 = torch.int32
    return s["acc_x"], s["steps"].to(i32), s["grads"], hist, s["iters"].to(i32)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library(kind: str = "diag"):
    """The library of the machine for metric ``kind``: each metric's
    instantiations are a source of their own (``csrc/fused_nuts_dc.cu``,
    ``fused_nuts_dc_dense.cu``, ``fused_nuts_dc_low_rank.cu``, over the
    shared ``csrc/fused_nuts_dc.cuh``), so that their builds run side by
    side."""
    return _bind(_nvcc.load(_LIBRARIES[kind]), kind)


def _bind(lib, kind: str):
    """Declare the C interface of a library of the machine for metric
    ``kind`` (also for a copy built with other constants, as
    ``logreg_dc_tiles.py`` builds them)."""
    lib.bjt_fused_nuts_dc.argtypes = (
        [_VP] * 22 + [_INT] * 13 + [_FLOAT, _FLOAT, _INT, ctypes.POINTER(_FLOAT), _VP]
    )
    lib.bjt_fused_nuts_dc.restype = _INT
    lib.bjt_dc_block_bytes.argtypes = [_INT] * 8
    lib.bjt_dc_block_bytes.restype = ctypes.c_longlong
    lib.bjt_dc_scratch_floats.argtypes = [_INT] * 4 + [_VP]
    lib.bjt_dc_scratch_floats.restype = _INT
    lib.bjt_dc_occupancy.argtypes = [_INT] * 4 + [_VP]
    lib.bjt_dc_occupancy.restype = _INT
    lib.bjt_error_string.argtypes = [_INT]
    lib.bjt_error_string.restype = ctypes.c_char_p
    if kind == "diag":
        lib.bjt_threefry2x32.argtypes = [_VP] * 6 + [_INT, _VP]
        lib.bjt_threefry2x32.restype = _INT
        lib.bjt_normal.argtypes = [_VP] * 3 + [_INT, _INT, _VP]
        lib.bjt_normal.restype = _INT
    return lib


def build() -> str:
    """Build (or load) the three kernel libraries, one ``nvcc`` each, all
    started together; returns the compiler's report of registers, shared
    memory and spills per kernel."""
    with ThreadPoolExecutor(max_workers=len(_LIBRARIES)) as pool:
        list(pool.map(_library, _LIBRARIES))
    return "".join(_nvcc.build_log(name) for name in _LIBRARIES.values())


@functools.lru_cache(maxsize=8)
def _matrix_on(target: TargetKernelDC, device: torch.device):
    """A matrix target's ``(X, X^T, u, s)`` on ``device`` (None where the
    target has none), copied once: both orientations of ``X``, so that each
    of the two contractions reads it coalesced."""
    m = target.matrix

    def up(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    X = up(m.X)
    Xt = None if X is None else X.t().contiguous()
    return X, Xt, up(m.u), up(m.s)


def _metric_operands(metric: DCMetric, d: int, dev):
    """The kernel's metric pointers ``(imm, sigma_m, imm_t, chol_t, U,
    lam_m1, isl_m1)`` (None where unused) and the rank. A dense matrix goes
    transposed, so that the lanes, each forming its own rows of ``A v``,
    read it coalesced."""
    ops = metric.ops
    if metric.kind == "diag":
        shapes = [(d,), (d,)]
        names = ("inverse_mass_matrix", "sigma_m")
    elif metric.kind == "dense":
        shapes = [(d, d), (d, d)]
        names = ("inverse_mass_matrix", "chol_mass")
    else:
        k = ops[2].shape[1]
        shapes = [(d,), (d,), (d, k), (k,), (k,)]
        names = ("sigma", "inv_sigma", "U", "lam_m1", "isl_m1")
    for name, t, shape in zip(names, ops, shapes):
        _nvcc.require_cuda_f32(name, t, dev, shape)
    if metric.kind == "diag":
        return (*ops, None, None, None, None, None), 0
    if metric.kind == "dense":
        imm, chol_mass = ops
        return (None, None, imm.T.contiguous(), chol_mass.T.contiguous(), None, None, None), 0
    sigma, inv_sigma, U, lam_m1, isl_m1 = ops
    return (sigma, inv_sigma, None, None, U, lam_m1, isl_m1), U.shape[1]


class SharedMemoryPlan(NamedTuple):
    """A launch's shared-memory layout: where the kernel reads the data
    matrix X from (``"shared"``, ``"l2"``, ``"tiles"``, or None for a target
    without one), the block's bytes of dynamic shared memory, whether the
    tiles form copies a dense or low-rank metric's matrices into shared
    memory (else it reads them from device memory), whether an analytic
    target takes the resident form, and whether eight schools takes the
    thread form."""

    x_form: Optional[str]
    nbytes: int
    metric_shared: bool = False
    resident: bool = False
    thread: bool = False

    @property
    def form(self) -> int:
        """The kernel's form argument: 1 for the horseshoe's X in shared
        memory and for the resident form, 2 for the thread form, else 0."""
        return 2 if self.thread else int(self.x_form == "shared" or self.resident)


def _register_width(d: int) -> int:
    """N, the registers per lane and vector of the instantiation for ``d``."""
    n = -(-d // 32)
    return next(w for w in _REGISTER_WIDTHS if w >= n)


def _cold_floats(n: int, resident: bool = False, metric: str = "diag") -> int:
    """Floats of a chain's scratch in device memory for the state vectors
    that the instantiation with ``n`` registers per vector keeps out of
    registers: in the resident form thirteen (the accepted state, the
    proposal, both ends, the subtree's sample, the momentum sum), fifteen
    with the ends' w of the dense and low-rank metrics
    (``resident_cold_floats`` in ``csrc/fused_nuts_dc.cuh``); in the others
    ten from ``n = 13`` up (``kColdState``)."""
    if resident:
        return (13 if metric == "diag" else 15) * n * 32
    return 10 * n * 32 if n >= 13 else 0


def _slot_floats(n: int, metric: str, max_depth: int) -> int:
    """Floats of a chain's checkpoint slots (``slot_floats``): m and msum,
    and w for the dense and low-rank metrics, at each of ``max_depth``
    levels."""
    return (2 if metric == "diag" else 3) * max_depth * n * 32


def scratch_floats(plan: "SharedMemoryPlan", n: int, metric: str, max_depth: int) -> tuple:
    """Floats of a chain's scratch in device memory that a launch under
    ``plan`` reads and writes: ``(cold vectors, checkpoint slots)``, as
    ``bjt_dc_scratch_floats`` counts them; the slots live there in the tiles
    form, and in the resident form where they do not fit in shared memory."""
    if plan.thread:
        return 0, 0
    slots = _slot_floats(n, metric, max_depth)
    if plan.resident:
        shared = _resident_slots_shared(n, metric, max_depth)
        return _cold_floats(n, True, metric), 0 if shared else slots
    return _cold_floats(n), slots if plan.x_form == "tiles" else 0


def resident_warps(n: int) -> int:
    """The warps an SM that the resident form's instantiation with ``n``
    registers per vector is built to hold (``resident_warps``): 24 up to
    ``n = 2``, 20 at ``n = 4``, 16 at ``n = 8``; its registers a thread are
    at most 65,536 over 32 of them."""
    return 24 if n <= 2 else 20 if n == 4 else 16


def _resident_shared_floats(n: int, metric: str, max_depth: int) -> int:
    """Floats of a resident warp's shared memory when its slots live there
    (``resident_shared_floats``): the dense and low-rank metrics' staging
    vector, the subtree's sample (x and g) and the checkpoint slots."""
    return (0 if metric == "diag" else n * 32) + 2 * n * 32 + _slot_floats(n, metric, max_depth)


def _resident_slots_shared(n: int, metric: str, max_depth: int) -> bool:
    """Whether the resident form keeps the slots and the subtree's sample in
    shared memory (``resident_slots_shared``): where the blocks of
    :func:`resident_warps` warps fit them on an SM."""
    blocks = resident_warps(n) // _RESIDENT_BLOCK_WARPS
    floats = _resident_shared_floats(n, metric, max_depth)
    return blocks * (_RESIDENT_BLOCK_WARPS * floats * 4 + _SMEM_RESERVED) <= _SMEM_PER_SM


def _thread_block_bytes(max_depth: int) -> int:
    """A thread-form block's bytes of shared memory (``thread_block_bytes``):
    its one warp's checkpoint slots (m and msum for 32 chains at each of
    ``max_depth`` levels), the proposal and the ends."""
    return 4 * (2 * max_depth + _THREAD_VECTORS) * _THREAD_DIM * 32


def _shared_x_stride(cols: int) -> int:
    """X's row stride in shared memory (``shared_x_stride``): ``cols``
    rounded up to a multiple of 4 that is 4 mod 8."""
    return _round_up(cols, 4) | 4


def _lr_tile_rows(n: int) -> int:
    """Rows of X a tile of the tiles form holds (``lr_tile_rows``)."""
    cap = 256 if n <= 2 else 128 if n <= 4 else 64 if n <= 8 else 32
    return min(cap, 32 * _CHAINS_LR)


def _lr_tiles(X, tile_rows: int) -> np.ndarray:
    """Logistic regression's ``X`` as the tiles form reads it: rows at the
    stride :func:`_shared_x_stride`, zero padded to whole tiles of
    ``tile_rows`` rows, so that every tile is one contiguous run of 16-byte
    words."""
    rows, cols = X.shape
    tiles = np.zeros((_round_up(rows, tile_rows), _shared_x_stride(cols)), np.float32)
    tiles[:rows, :cols] = X
    return tiles


@functools.lru_cache(maxsize=8)
def _lr_tiles_on(target: TargetKernelDC, device: torch.device, tile_rows: int):
    """The tiles form's ``(X as tiles, None, u, None)`` on ``device``,
    copied once."""
    m = target.matrix
    tiles = torch.from_numpy(_lr_tiles(m.X, tile_rows)).to(device)
    return tiles, None, torch.from_numpy(np.ascontiguousarray(m.u, np.float32)).to(device), None


def _lr_tiles_floats(n: int, cols: int) -> int:
    """Floats of the tiles form's gradient in shared memory
    (``lr_tiles_floats``): the ring of two tiles (or the backward pass's
    partial sums, which reuse it, if larger), the positions and the
    sigmoids."""
    R = _lr_tile_rows(n)
    back_chains = 1 if n > 8 else min(16 // n, _CHAINS_LR)
    region = max(2 * R * _shared_x_stride(cols), back_chains * _CHAINS_LR * 32 * n)
    return region + _round_up(cols, 4) * _CHAINS_LR + R * _CHAINS_LR


def shared_memory_plan(n: int, family: int, metric: str, max_depth: int, rows: int = 0,
                       cols: int = 0, rank: int = 0) -> SharedMemoryPlan:
    """The block's layout for the instantiation with ``n`` registers per
    vector, target family ``family`` (a ``cuda_target`` id), metric kind
    ``metric`` (of rank ``rank`` if low-rank), ``max_depth`` checkpoint
    slots and a ``(rows, cols)`` data matrix; it mirrors ``block_bytes`` in
    ``csrc/fused_nuts_dc.cuh``.

    Logistic regression takes the tiles form: its :data:`_CHAINS_LR`
    warps share the gradient's tiles (:func:`_lr_tiles_floats`), each holds
    a staging vector for the dense and low-rank metrics, and the checkpoint
    slots live in device memory (at ``d = 256`` and ``max_depth`` 10 eight
    warps' slots alone would take 164 KB for the diagonal metric, 254 KB for
    the dense one); a dense metric's ``M^{-1}`` and ``C^T``, or a low-rank
    one's ``U``, ``lam - 1`` and ``1 / sqrt(lam) - 1``, are copied into
    shared memory where they fit beside the rest.

    The analytic targets take the resident form at the widths of
    :data:`RESIDENT_WIDTHS`: its warps (one a block) keep most of their state
    in device memory, and hold in shared memory the dense and low-rank
    metrics' staging vector and, where the SM's blocks fit them
    (:func:`_resident_slots_shared`), the subtree's sample and the
    checkpoint slots. Elsewhere each of the
    four warps holds its checkpoint slots (m and msum; w and a
    staging vector besides for the dense and low-rank metrics) and a matrix
    target's scratch. The horseshoe takes the form that copies X into shared
    memory (``rows`` rows of ``cols`` rounded up to a multiple of 4 that is 4
    mod 8 floats: 204 for 200 columns) where that and the warps fit in
    :data:`SHARED_MEMORY_LIMIT`, and reads X from L2 where they do not; the
    choice is made here, before the launch, and never on a failed one. Eight
    schools under the diagonal metric takes the thread form where
    ``_EIGHT_SCHOOLS_THREAD`` is set: :func:`_thread_block_bytes`, nothing in
    device memory."""
    if _EIGHT_SCHOOLS_THREAD and family == _CUDA_EIGHT_SCHOOLS and metric == "diag":
        return SharedMemoryPlan(None, _thread_block_bytes(max_depth), thread=True)
    vec = n * 32
    analytic = family in (_CUDA_HIERARCHICAL, _CUDA_GAUSSIAN)
    if analytic and n in RESIDENT_WIDTHS[metric]:
        floats = (_resident_shared_floats(n, metric, max_depth)
                  if _resident_slots_shared(n, metric, max_depth)
                  else 0 if metric == "diag" else vec)
        return SharedMemoryPlan(None, 4 * _RESIDENT_BLOCK_WARPS * floats, resident=True)
    if family == _CUDA_LOGREG:
        tiles = 4 * (_lr_tiles_floats(n, cols) + (0 if metric == "diag" else _CHAINS_LR * vec))
        matrices = 4 * {"diag": 0, "dense": 2 * cols * cols,
                        "low_rank": cols * rank + 2 * rank}[metric]
        if matrices and tiles + matrices <= SHARED_MEMORY_LIMIT:
            return SharedMemoryPlan("tiles", tiles + matrices, True)
        return SharedMemoryPlan("tiles", tiles)
    slots = 2 * max_depth * vec if metric == "diag" else (3 * max_depth + 1) * vec
    if family == _CUDA_HORSESHOE:
        scratch = 2 * vec + 16 * n  # x, the gradient, beta
    elif analytic:
        scratch = 0
    else:
        scratch = 3 * vec + 32
    warps = 4 * _WARPS * (slots + scratch)
    if family == _CUDA_HORSESHOE:
        shared = warps + 4 * rows * (_round_up(cols, 4) | 4)
        if shared <= SHARED_MEMORY_LIMIT:
            return SharedMemoryPlan("shared", shared)
    return SharedMemoryPlan("l2" if family in (_CUDA_LOGREG, _CUDA_HORSESHOE) else None, warps)


def _launch_cuda(x, metric, step_size, *, target, num_steps, max_depth,
                 seed, track_rows, budget, chunk, divergence_threshold,
                 restart_every=1, budgets=None):
    del chunk  # the kernel stops each chain on its own
    C, d = x.shape
    if d > _MAX_CUDA_DIM:
        raise NotImplementedError(
            f"the CUDA machine holds d <= {_MAX_CUDA_DIM} per warp; got d={d}"
        )
    if metric.kind != "diag" and d > _MAX_CUDA_DIM_METRIC:
        raise NotImplementedError(
            f"the CUDA machine's {metric.kind} metric holds d <= {_MAX_CUDA_DIM_METRIC} "
            f"per warp; got d={d} (ROADMAP queue 2, item 2f)"
        )
    dev = x.device
    inv_var = None
    matrix = (None,) * 4
    rows = cols = 0
    scalars = ()
    if target.matrix is not None:
        if target.matrix.X is not None:
            rows, cols = target.matrix.X.shape
        scalars = target.matrix.scalars
    elif target.params:
        inv_var = torch.tensor(target.params[0], dtype=torch.float32, device=dev)
    _nvcc.require_cuda_f32("positions", x, dev, (C, d))
    metric_ptrs, rank = _metric_operands(metric, d, dev)
    if inv_var is not None:
        _nvcc.require_cuda_f32("inv_var", inv_var, dev, (d,))
    if budgets is not None:
        budgets = budgets.to(device=dev, dtype=torch.int32).contiguous()
    n = _register_width(d)
    plan = shared_memory_plan(n, target.cuda_target, metric.kind, max_depth, rows, cols, rank)
    if plan.x_form == "tiles":
        matrix = _lr_tiles_on(target, dev, _lr_tile_rows(n))
    elif target.matrix is not None:
        matrix = _matrix_on(target, dev)
    lib = _library(metric.kind)
    out_x = torch.empty_like(x)
    out_steps = torch.empty(C, dtype=torch.int32, device=dev)
    out_grads = torch.empty(C, dtype=torch.float32, device=dev)
    out_iters = torch.empty(C, dtype=torch.int32, device=dev)
    hist = torch.zeros(C, num_steps, len(track_rows), dtype=torch.float32, device=dev)
    cold_floats, slot_floats = scratch_floats(plan, n, metric.kind, max_depth)
    # the tiles form's warps past the last chain write their cold vectors too
    cold_chains = _round_up(C, _CHAINS_LR) if plan.x_form == "tiles" else C
    cold = (torch.empty(cold_chains * cold_floats, dtype=torch.float32, device=dev)
            if cold_floats else None)
    slots = (torch.empty(C * slot_floats, dtype=torch.float32, device=dev)
             if slot_floats else None)
    track = torch.tensor(track_rows, dtype=torch.int32, device=dev)
    k = (_FLOAT * _MAX_SCALARS)(*scalars)

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = lib.bjt_fused_nuts_dc(
        x.data_ptr(), *map(ptr, metric_ptrs), ptr(inv_var),
        track.data_ptr(), ptr(budgets), out_x.data_ptr(), out_steps.data_ptr(),
        out_grads.data_ptr(), hist.data_ptr(), out_iters.data_ptr(), ptr(cold), ptr(slots),
        *map(ptr, matrix),
        C, d, num_steps, len(track_rows), max_depth, budget, restart_every,
        target.cuda_target, rows, cols, plan.form, rank,
        int(plan.metric_shared), float(step_size), float(divergence_threshold), seed, k,
        _nvcc.stream_handle(dev),
    )
    _nvcc.check_launch(lib, code, "fused_nuts_dc")
    LAUNCHES["fused_nuts_dc"] += 1
    if plan.x_form is not None:
        LAUNCHES[f"fused_nuts_dc:x_{plan.x_form}"] += 1
    elif target.matrix is None:
        LAUNCHES[f"fused_nuts_dc:analytic_{'resident' if plan.resident else 'registers'}"] += 1
    else:  # eight schools
        LAUNCHES[f"fused_nuts_dc:{'thread' if plan.thread else 'registers'}"] += 1
    return out_x, out_steps, out_grads, hist, out_iters


def occupancy(d: int, metric: str = "diag", form: int = 1,
              target: int = _CUDA_HIERARCHICAL, max_depth: int = 8) -> dict:
    """What the card reports for the instantiation for ``d`` in the kernel's
    form ``form`` (:attr:`SharedMemoryPlan.form`): an analytic target's
    resident form (1) or registers form (0), or eight schools'
    (``target=_CUDA_EIGHT_SCHOOLS``) thread form (2) or registers form (0).
    Its resident warps an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    its registers and its local memory a thread in bytes (its stack frame
    and any spills). Needs the card."""
    out = (_INT * 3)()
    code = _library(metric).bjt_dc_occupancy(d, target, form, max_depth, out)
    _nvcc.check_launch(_library(metric), code, "bjt_dc_occupancy")
    return {"warps_per_sm": out[0], "registers": out[1], "local_bytes": out[2]}


def lockstep_idle_share(steps, iters, num_steps: int, budget):
    """The share of warp-iterations of the tiles form in which a warp was
    not live, from one launch's per-chain ``steps`` and ``iters`` (the
    outputs of the kernel launch) and its ``budget`` (an int, or per-chain
    budgets): a chain is live until it closes its last transition (``iters``
    iterations) or, short of ``num_steps``, until its budget runs out, and
    its block runs the loop until its last chain is done. Warps past the
    last chain of a partial last block count as idle throughout."""
    k = _CHAINS_LR
    steps, iters = steps.cpu().long(), iters.cpu().long()
    budgets = torch.as_tensor(budget).cpu().long().expand_as(steps)
    live = torch.where(steps >= num_steps, iters, budgets)
    blocks = torch.nn.functional.pad(live, (0, _round_up(live.numel(), k) - live.numel()))
    held = int(blocks.view(-1, k).max(1).values.sum()) * k
    return 1.0 - int(live.sum()) / held if held else 0.0


def _lane_budgets(steps, iters, *, num_steps, budget, chunk, pack, tile_chains):
    """Per-chain leaf budgets under the reference's lane schedule.

    The Pallas kernel runs ``pack`` chains one after the other on each lane
    of a ``tile_chains``-wide tile: chain ``i * T * pack + k * T + j`` is the
    ``k``-th chain of lane ``(i, j)``, and it starts at the first chunk
    boundary after chain ``k - 1`` of that lane closed its last transition,
    if that one finished inside the lane's ``budget``. ``steps`` and
    ``iters`` come from a run in which every chain had the whole ``budget``
    on its own clock; a chain's path does not depend on when it starts, so
    they give each chain's start. Returns ``budget - start`` per chain, 0
    for a chain its lane never reaches (it keeps its initial position and
    zero history, as in the reference)."""
    C = steps.shape[0]
    T = max(128, _round_up(min(tile_chains, max(C, 1)), 128))
    c_pad = _round_up(C, T * pack)
    shape = (c_pad // (T * pack), pack, T)
    finished = torch.zeros(c_pad, dtype=torch.bool)
    finished[:C] = steps.cpu() == num_steps
    used = torch.zeros(c_pad, dtype=torch.int64)
    used[:C] = iters.cpu()
    finished, used = finished.view(shape), used.view(shape)
    start = torch.zeros(shape, dtype=torch.int64)
    reached = torch.zeros(shape, dtype=torch.bool)
    reached[:, 0] = True
    for k in range(1, pack):
        end = start[:, k - 1] + used[:, k - 1]  # one past the closing leaf
        start[:, k] = (end - 1) // chunk * chunk + chunk
        reached[:, k] = (
            reached[:, k - 1] & finished[:, k - 1] & (end <= budget) & (start[:, k] < budget)
        )
    return torch.where(reached, budget - start, 0).reshape(-1)[:C]


def _run(machine_fn, x, metric, step_size, machine, pack, tile_chains):
    """One machine run (``machine_fn`` is the kernel launch or the plain
    version); with ``pack > 1`` a second run with per-chain budgets where
    the lane schedule cuts some chain short."""
    out = machine_fn(x, metric, step_size, **machine)
    if pack > 1:
        steps, iters = out[1].cpu(), out[4].cpu()
        budget = machine["budget"]
        budgets = _lane_budgets(
            steps, iters, num_steps=machine["num_steps"], budget=budget,
            chunk=machine["chunk"], pack=pack, tile_chains=tile_chains,
        )
        in_time = (steps == machine["num_steps"]) & (iters <= budgets)
        if not bool((in_time | (budgets == budget)).all()):
            out = machine_fn(x, metric, step_size, budgets=budgets, **machine)
    acc_x, steps, grads, hist, _ = out
    return acc_x, hist, grads.sum(), steps


def _dc_metric(inverse_mass_matrix, d: int, dev) -> DCMetric:
    """The metric operands of a ``(d,)`` (or scalar), ``(d, d)`` or
    low-rank inverse mass matrix, in f32 on ``dev``, built as the reference
    builds them (``fused_nuts_dc.py:837-893``)."""
    f32 = torch.float32
    if isinstance(inverse_mass_matrix, LowRankInverseMassMatrix):
        sigma, U, lam = (torch.as_tensor(a).to(device=dev, dtype=f32)
                         for a in inverse_mass_matrix)
        if sigma.shape != (d,) or U.dim() != 2 or U.shape[0] != d or lam.shape != U.shape[1:]:
            raise ValueError(
                f"low-rank metric shapes sigma {tuple(sigma.shape)}, U {tuple(U.shape)}, lam "
                f"{tuple(lam.shape)} do not fit d={d}"
            )
        ops = (sigma, 1.0 / sigma, U, lam - 1.0, 1.0 / torch.sqrt(lam) - 1.0)
        return DCMetric("low_rank", tuple(t.contiguous() for t in ops))
    if callable(inverse_mass_matrix):
        raise NotImplementedError(
            "a position-dependent (Riemannian) metric is not ported to the machine: it takes "
            "diagonal, dense and low-rank inverse mass matrices"
        )
    imm = torch.as_tensor(inverse_mass_matrix).to(device=dev, dtype=f32)
    if imm.dim() == 2:
        # C with C C^T = M: M^{-1} = L L^T gives C = L^{-T}, an f32 Cholesky
        # and a triangular solve with the transpose, as the reference
        L = torch.linalg.cholesky(imm)
        eye = torch.eye(d, dtype=f32, device=dev)
        chol_mass = torch.linalg.solve_triangular(L.T, eye, upper=True)
        return DCMetric("dense", (imm.contiguous(), chol_mass.contiguous()))
    imm = torch.broadcast_to(imm, (d,)).contiguous()
    # momentum scale sqrt(1 / imm), zero where imm <= 0 (the reference's
    # masked form, fused_nuts_dc.py:884-891)
    pos = imm > 0.0
    sigma_m = torch.sqrt(torch.where(pos, 1.0 / torch.where(pos, imm, 1.0), 0.0))
    return DCMetric("diag", (imm, sigma_m))


def _prepare(
    positions, inverse_mass_matrix, *, target, num_steps, max_num_doublings=8,
    seed=0, num_track=8, track_rows=None, budget=None, chunk=128, pack=1,
    restart_every=1, divergence_threshold=1000.0,
):
    """Validate as the reference does; return the f32 positions, the
    metric's operands and the machine's arguments."""
    C, d = positions.shape
    if d != target.dim:
        raise ValueError(f"positions dim {d} != registered target dim {target.dim}")
    if num_track > d:
        raise ValueError(f"num_track={num_track} > dim {d}")
    if track_rows is not None:
        track_rows = tuple(int(r) for r in track_rows)
        if len(track_rows) != num_track:
            raise ValueError(
                f"track_rows has {len(track_rows)} entries, expected "
                f"num_track={num_track}"
            )
        if any(r < 0 or r >= d for r in track_rows):
            raise ValueError(f"track_rows out of range [0, {d}): {track_rows}")
    else:
        track_rows = tuple(range(num_track))
    if pack < 1:
        raise ValueError(f"pack must be >= 1, got {pack}")
    if restart_every < 1 or chunk % restart_every != 0:
        raise ValueError(
            f"restart_every must be >= 1 and divide chunk, got "
            f"{restart_every} (chunk={chunk})"
        )
    if not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    if budget is None:
        budget = 32 * num_steps * pack
    x = positions.to(torch.float32).contiguous()
    metric = _dc_metric(inverse_mass_matrix, d, x.device)
    machine = dict(
        target=target, num_steps=num_steps, max_depth=max_num_doublings,
        seed=int(seed), track_rows=track_rows, budget=_round_up(budget, chunk),
        chunk=chunk, divergence_threshold=divergence_threshold,
        restart_every=restart_every,
    )
    return x, metric, machine


def fused_nuts_run_dc(
    positions,
    inverse_mass_matrix,
    step_size,
    *,
    target: TargetKernelDC,
    num_steps: int,
    max_num_doublings: int = 8,
    seed: int = 0,
    num_track: int = 8,
    track_rows: tuple = None,
    tile_chains: int = 128,
    budget: int = None,
    chunk: int = 128,
    pack: int = 1,
    restart_every: int = 1,
    divergence_threshold: float = 1000.0,
):
    """Run ``num_steps`` NUTS transitions per chain.

    ``positions`` is ``(C, d)``; the inverse mass matrix is diagonal ``(d,)``
    (or a scalar), dense ``(d, d)``, or a
    :class:`~blackjax_tpu_torch.mcmc.metrics.LowRankInverseMassMatrix`, as
    the reference accepts. Returns ``(final_positions (C, d), history (C,
    num_steps, num_track), total_grads (), steps (C,) int32)``, as the
    reference does. ``steps[c] < num_steps`` means the leaf ``budget`` ran
    out before chain ``c`` finished; ``budget`` (default ``32 * num_steps *
    pack``) counts leaf iterations per lane of ``pack`` chains, as in the
    reference, and is rounded up to a multiple of ``chunk``.
    ``restart_every`` (a divisor of ``chunk``) gates restarts to every
    ``restart_every``-th leaf. Both change which chains the budget cuts
    short and nothing else; with ``pack > 1`` a binding budget costs a
    second run. History records coordinates ``0..num_track-1``, or
    ``track_rows``.

    A CUDA tensor launches the kernel of its metric; a CPU tensor runs the
    plain version. Chain ids are local to the call: callers that split
    chains across devices offset ``seed``.
    """
    kwargs = dict(
        target=target, num_steps=num_steps, max_num_doublings=max_num_doublings,
        seed=seed, num_track=num_track, track_rows=track_rows, budget=budget,
        chunk=chunk, pack=pack, restart_every=restart_every,
        divergence_threshold=divergence_threshold,
    )
    x, metric, machine = _prepare(positions, inverse_mass_matrix, **kwargs)
    if x.device.type == "cuda":
        machine_fn = _launch_cuda
    elif x.device.type == "cpu":
        machine_fn = _machine_plain
    else:
        raise NotImplementedError(f"no machine for device type {x.device.type!r}")
    return _run(machine_fn, x, metric, float(step_size), machine, pack, tile_chains)


def fused_nuts_run_dc_plain(positions, inverse_mass_matrix, step_size, **kwargs):
    """The plain PyTorch version of :func:`fused_nuts_run_dc`, with the same
    arguments and outputs, on the device of ``positions``: on the card it is
    the kernel's reference. It launches nothing of ours and counts nothing."""
    tile_chains = kwargs.pop("tile_chains", 128)
    pack = kwargs.get("pack", 1)
    x, metric, machine = _prepare(positions, inverse_mass_matrix, **kwargs)
    return _run(_machine_plain, x, metric, float(step_size), machine, pack, tile_chains)


def normal_device(t0, t1, dtype):
    """``jax.random.normal``'s transform of threefry words ``(t0, t1)`` (int64
    CUDA tensors of one shape, :func:`blackjax_tpu_torch.prng._words`) into
    float32 or float64 normals: one launch of ``bjt_normal``, the bits of
    :func:`blackjax_tpu_torch.prng.normal_from_words`, its plain version."""
    if t0.device.type != "cuda":
        raise ValueError("normal_device takes CUDA tensors; prng.normal_from_words is the "
                         "plain version")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"normal draws in {dtype} are not ported")
    w0, w1 = (w.to(torch.int64).contiguous() for w in torch.broadcast_tensors(t0, t1))
    out = torch.empty(w0.shape, dtype=dtype, device=w0.device)
    lib = _library("diag")
    code = lib.bjt_normal(w0.data_ptr(), w1.data_ptr(), out.data_ptr(), out.numel(),
                          int(dtype == torch.float64), _nvcc.stream_handle(w0.device))
    _nvcc.check_launch(lib, code, "normal")
    LAUNCHES["normal"] += 1
    return out


def threefry2x32_device(k0, k1, c0, c1):
    """threefry2x32 of ``(c0, c1)`` under the key ``(k0, k1)`` through the
    kernel's own device function (CUDA tensors) or the plain version (CPU
    tensors). Keys and counters are ints or int64 tensors in ``[0, 2**32)``,
    broadcast against each other (a key per element); returns the two output
    words the same way. One launch per call."""
    tensors = [t for t in (k0, k1, c0, c1) if torch.is_tensor(t)]
    if not tensors or tensors[0].device.type != "cuda":
        return threefry2x32(k0, k1, c0, c1)
    dev = tensors[0].device
    words = torch.broadcast_tensors(
        *(torch.as_tensor(w, dtype=torch.int64, device=dev) for w in (k0, k1, c0, c1)))
    words = [w.contiguous() for w in words]  # the kernel reads the low 32 bits
    o0, o1 = torch.empty_like(words[0]), torch.empty_like(words[0])
    lib = _library("diag")
    code = lib.bjt_threefry2x32(
        *(w.data_ptr() for w in words), o0.data_ptr(), o1.data_ptr(), o0.numel(),
        _nvcc.stream_handle(dev),
    )
    _nvcc.check_launch(lib, code, "threefry2x32")
    LAUNCHES["threefry2x32"] += 1
    return o0, o1

